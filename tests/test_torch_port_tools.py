"""The port's copies of the framework-free tools against the JAX package's,
on temporary directories on the CPU: data/tools.py (split, preprocess, vox),
data/bg_removal.py and utils/user_study.py with its command line
(scripts/user_study.py's). The JAX package's tools read and write through
imageio and split with sklearn; the port's through Pillow and its own copy
of the split, as the card's machine has neither.

Limits: the same train/test lists; PNG outputs pixel-equal; JPG outputs
decoded within 1 of 255 (both encoders are Pillow's at quality 75); the
background removal equal under one cv2; the study's files byte-equal and
its analysis equal.
"""

from __future__ import annotations

import os
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from monkeynet_tpu.data import bg_removal as jbg
from monkeynet_tpu.data import tools as jtools
from monkeynet_tpu.utils import user_study as jus
from monkeynet_tpu_torch.data import bg_removal as tbg
from monkeynet_tpu_torch.data import tools as ttools
from monkeynet_tpu_torch.utils import user_study as tus

REPO = Path(__file__).resolve().parent.parent
JPG_ATOL = 1  # of 255


def _listing(root: Path) -> dict:
    return {split: sorted(os.listdir(root / split)) for split in ("train", "test")}


@pytest.mark.parametrize("n", [2, 5, 10, 21, 64, 103])
def test_split_gives_the_jax_package_lists(tmp_path, n):
    """split_train_test at its default test_size 0.1 moves the same files
    into train/ and test/ as the JAX package's sklearn split."""
    roots = {}
    for label, split in (("jax", jtools.split_train_test), ("port", ttools.split_train_test)):
        root = tmp_path / label
        root.mkdir()
        for i in range(n):
            (root / f"{(i * 7919) % 1000:04d}.png").write_bytes(b"x")
        split(str(root))
        roots[label] = _listing(root)
        assert not [p for p in os.listdir(root) if p not in ("train", "test")]
    assert roots["port"] == roots["jax"]
    assert len(roots["port"]["test"]) == int(np.ceil(0.1 * n))


def test_split_refuses_what_sklearn_refuses(tmp_path):
    """One file at test_size 0.1 leaves the train set empty; no files at all
    is an error of the tool itself."""
    for split in (jtools.split_train_test, ttools.split_train_test):
        root = tmp_path / split.__module__
        root.mkdir()
        with pytest.raises(ValueError, match="no files"):
            split(str(root))
        (root / "0.png").write_bytes(b"x")
        with pytest.raises(ValueError):
            split(str(root))


def _frames(root: Path, videos: int, frames: int, seed: int, sizes=((40, 30), (24, 24)),
            rgba: bool = False):
    """Frame folders of random pixels; with `rgba`, the second video's
    frames carry an alpha channel (a JPG cannot hold one)."""
    rng = np.random.RandomState(seed)
    for v in range(videos):
        vdir = root / f"video{v}"
        vdir.mkdir(parents=True)
        w, h = sizes[v % len(sizes)]
        mode = "RGBA" if rgba and v == 1 else "RGB"
        for f in range(frames):
            pixels = rng.randint(0, 256, (h, w, len(mode))).astype(np.uint8)
            Image.fromarray(pixels, mode).save(vdir / f"{f:03d}.png")


def _assert_images_match(got_dir: Path, want_dir: Path, fmt: str) -> int:
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        got = np.asarray(Image.open(got_dir / name)).astype(int)
        want = np.asarray(Image.open(want_dir / name)).astype(int)
        assert got.shape == want.shape, name
        limit = 0 if fmt == "png" else JPG_ATOL
        assert np.abs(got - want).max() <= limit, name
    return len(names)


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_preprocess_frames_dir_matches_the_jax_package(tmp_path, fmt):
    """Per-video frame folders (PNGs of two sizes, RGBA ones for a PNG
    output, one folder over the warning's 100 frames) to one stacked image
    each, resized to 32^2 with area interpolation."""
    _frames(tmp_path / "in", videos=3, frames=4, seed=1, rgba=fmt == "png")
    _frames(tmp_path / "long", videos=1, frames=101, seed=2, sizes=((8, 8),))
    shutil.move(str(tmp_path / "long" / "video0"), str(tmp_path / "in" / "video9"))
    (tmp_path / "in" / "stray.txt").write_text("not a folder")
    jtools.preprocess_frames_dir(str(tmp_path / "in"), str(tmp_path / "jax"), 32, fmt)
    ttools.preprocess_frames_dir(str(tmp_path / "in"), str(tmp_path / "port"), 32, fmt)
    assert _assert_images_match(tmp_path / "port", tmp_path / "jax", fmt) == 4


def test_preprocess_vox_matches_the_jax_package(tmp_path):
    """The vox layout <celeb>/1.6/<video>/<part>/ partitioned by the lists;
    a celeb in a list but not on disk is skipped."""
    lists = tmp_path / "lists"
    lists.mkdir()
    (lists / "train_vox1.txt").write_text("id1\nid2\nid9\n")
    (lists / "test_vox1.txt").write_text("id3\n")
    for i, celeb in enumerate(("id1", "id2", "id3")):
        for video in ("vA", "vB"):
            _frames(tmp_path / "vox" / celeb / "1.6" / video, videos=1 + i % 2, frames=4,
                    seed=i)
    for label, fn in (("jax", jtools.preprocess_vox), ("port", ttools.preprocess_vox)):
        fn(str(tmp_path / "vox"), str(tmp_path / label), str(lists), 16, "jpg")
    for partition in ("train", "test"):
        assert _assert_images_match(tmp_path / "port" / partition, tmp_path / "jax" / partition,
                                    "jpg") > 0


def test_tools_cli_splits_as_the_jax_package(tmp_path, monkeypatch):
    """`python -m monkeynet_tpu_torch.data.tools split` and `preprocess`
    against the JAX package's CLI, and `vox` with the repository's lists
    over a tree that holds none of their celebs."""
    for label in ("jax", "port"):
        root = tmp_path / label / "videos"
        root.mkdir(parents=True)
        for i in range(12):
            (root / f"{i:03d}.png").write_bytes(b"x")
        _frames(tmp_path / label / "frames", videos=2, frames=3, seed=4, rgba=True)
    monkeypatch.setattr(sys, "argv", ["tools", "split", str(tmp_path / "jax" / "videos"),
                                      "--seed", "3"])
    jtools.main()
    ttools.main(["split", str(tmp_path / "port" / "videos"), "--seed", "3"])
    assert _listing(tmp_path / "port" / "videos") == _listing(tmp_path / "jax" / "videos")
    monkeypatch.setattr(sys, "argv", ["tools", "preprocess", str(tmp_path / "jax" / "frames"),
                                      str(tmp_path / "jax" / "out"), "--size", "16",
                                      "--format", "png"])
    jtools.main()
    ttools.main(["preprocess", str(tmp_path / "port" / "frames"), str(tmp_path / "port" / "out"),
                 "--size", "16", "--format", "png"])
    _assert_images_match(tmp_path / "port" / "out", tmp_path / "jax" / "out", "png")
    (tmp_path / "vox").mkdir()
    ttools.main(["vox", str(tmp_path / "vox"), str(tmp_path / "vox_out")])
    assert _listing(tmp_path / "vox_out") == {"train": [], "test": []}


def test_bg_removal_matches_the_jax_package(tmp_path, monkeypatch):
    """GrabCut per frame on the demo's driving video at 64^2: the arrays
    equal, and both CLIs write the same PNG."""
    from monkeynet_tpu_torch.data.io import read_video

    driving = str(REPO / "data" / "demo" / "driving.png")
    video = read_video(driving, (64, 64, 3))[:3]
    got, want = tbg.remove_background_video(video, 2), jbg.remove_background_video(video, 2)
    assert np.array_equal(got, want)
    assert (got == 1.0).all(axis=-1).mean() > 0.05  # some background turned white
    flat = np.full((8, 8, 3), 7, np.uint8)
    assert np.array_equal(tbg.remove_background_frame(flat), jbg.remove_background_frame(flat))
    monkeypatch.setattr(sys, "argv", ["bg", driving, str(tmp_path / "jax.png"),
                                      "--image_shape", "64", "--iterations", "1"])
    jbg.main()
    tbg.main([driving, str(tmp_path / "port.png"), "--image_shape", "64", "--iterations", "1"])
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          np.asarray(Image.open(tmp_path / "jax.png")))


def _study_outputs(root: Path, n: int = 12) -> None:
    for sub in ("ours", "baseline", "appearance"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        cid = f"{i * 37:08d}"
        (root / "ours" / f"mtm-{cid}.gif").write_bytes(b"GIF89a")
        (root / "baseline" / f"x2face-{cid}.mp4").write_bytes(b"\0")
        (root / "appearance" / f"{cid}.jpg").write_bytes(b"\xff\xd8\xff")
    (root / "ours" / "notes.txt").write_text("skipped")


@pytest.mark.parametrize("seed", [0, 5])
def test_user_study_functions_match_the_jax_package(tmp_path, seed):
    """Manifest rows, manifest and key files, both page flavors in both
    modes and the analysis of a responses file, for one seed."""
    _study_outputs(tmp_path)
    args = (str(tmp_path / "ours"), str(tmp_path / "baseline"), str(tmp_path / "appearance"))
    rows = {}
    for label, us in (("jax", jus), ("port", tus)):
        rows[label] = us.make_manifest(*args, study_name="s", seed=seed)
        us.write_manifest(rows[label], str(tmp_path / f"{label}-manifest.csv"))
        us.write_key(rows[label], str(tmp_path / f"{label}-key.csv"))
    assert [r.__dict__ for r in rows["port"]] == [r.__dict__ for r in rows["jax"]]
    for name in ("manifest.csv", "key.csv"):
        assert (tmp_path / f"port-{name}").read_bytes() == (tmp_path / f"jax-{name}").read_bytes()
    assert tus.read_manifest(str(tmp_path / "port-manifest.csv")) == \
        jus.read_manifest(str(tmp_path / "jax-manifest.csv"))
    jrows = [jus.ManifestRow(**r.__dict__) for r in rows["port"]]
    for mode in ("transfer", "prediction"):
        for flavor in ("local", "template"):
            assert tus.render_study_page(rows["port"], mode=mode, flavor=flavor,
                                         asset_prefix="media/") == \
                jus.render_study_page(jrows, mode=mode, flavor=flavor, asset_prefix="media/")
    rng = np.random.RandomState(seed)
    with open(tmp_path / "responses.csv", "w") as f:
        f.write("first,choice\n")
        for r in rows["port"] * 3:
            f.write(f"{r.first},{'optionA' if rng.rand() < 0.7 else 'optionB'}\n")
    got = tus.analyze_responses(str(tmp_path / "responses.csv"), str(tmp_path / "port-key.csv"))
    want = jus.analyze_responses(str(tmp_path / "responses.csv"), str(tmp_path / "jax-key.csv"))
    assert got.__dict__ == want.__dict__ and got.n == 36
    for k, n in ((0, 10), (3, 10), (17, 40), (500, 1000)):
        assert tus._wilson(k, n) == jus._wilson(k, n)
        assert tus._binom_two_sided(k, n) == jus._binom_two_sided(k, n)


def test_user_study_cli_matches_the_script(tmp_path, monkeypatch, capsys):
    """`python -m monkeynet_tpu_torch.utils.user_study make / page / analyze`
    against scripts/user_study.py: the same files and the same report."""
    _study_outputs(tmp_path)
    printed = {}
    for label in ("jax", "port"):
        out = tmp_path / label
        calls = [
            ["make", "--ours", str(tmp_path / "ours"), "--baseline", str(tmp_path / "baseline"),
             "--appearance", str(tmp_path / "appearance"), "--study-name", "st", "--seed", "4",
             "--out", str(out)],
            ["page", "--manifest-dir", str(out), "--mode", "prediction"],
        ]
        for argv in calls:
            if label == "jax":
                monkeypatch.setattr(sys, "argv", ["user_study.py", *argv])
                runpy.run_path(str(REPO / "scripts" / "user_study.py"), run_name="__main__")
            else:
                tus.main(argv)
        with open(out / "responses.csv", "w") as f:
            f.write("first,choice\n")
            for i, line in enumerate((out / "key.csv").read_text().splitlines()[1:]):
                f.write(f"{line.split(',')[0]},{'optionA' if i % 3 else 'optionB'}\n")
        argv = ["analyze", "--responses", str(out / "responses.csv"), "--key",
                str(out / "key.csv")]
        capsys.readouterr()
        if label == "jax":
            monkeypatch.setattr(sys, "argv", ["user_study.py", *argv])
            runpy.run_path(str(REPO / "scripts" / "user_study.py"), run_name="__main__")
        else:
            tus.main(argv)
        printed[label] = capsys.readouterr().out
    for name in ("manifest.csv", "key.csv", "index.html"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert printed["port"] == printed["jax"] and printed["port"].startswith("n=12 votes")
