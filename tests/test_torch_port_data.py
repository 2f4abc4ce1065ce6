"""The PyTorch port's host data path and logging held against the JAX
package's on the CPU: decode, augmentation, dataset and loader batches
(exactly), the feeder that stages batches, the Logger's lines, the
visualizer, checkpoint files and the log directory.

The videos are stacked PNGs written to a temporary directory, 16^2 frames
as in the train tests."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from monkeynet_tpu.data import native as jnative
from monkeynet_tpu.data.dataset import FramesDataset as JFramesDataset
from monkeynet_tpu.data.io import read_video as jread_video
from monkeynet_tpu.data.loader import DataLoader as JDataLoader
from monkeynet_tpu.data.loader import quantize_feed as jquantize_feed
from monkeynet_tpu.utils.config import prepare_log_dir as jprepare_log_dir
from monkeynet_tpu.utils.logger import Logger as JLogger
from monkeynet_tpu.utils.visualizer import Visualizer as JVisualizer
from monkeynet_tpu_torch.data import native as tnative
from monkeynet_tpu_torch.data.dataset import FramesDataset as TFramesDataset
from monkeynet_tpu_torch.data.io import decode_video, read_video, write_gif, write_stacked_png
from monkeynet_tpu_torch.data.loader import DataLoader as TDataLoader
from monkeynet_tpu_torch.data.loader import DevicePrefetch
from monkeynet_tpu_torch.data.loader import quantize_feed as tquantize_feed
from monkeynet_tpu_torch.utils.async_write import AsyncWriter
from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint, save_checkpoint
from monkeynet_tpu_torch.utils.config import prepare_log_dir as tprepare_log_dir
from monkeynet_tpu_torch.utils.logger import Logger as TLogger
from monkeynet_tpu_torch.utils.visualizer import Visualizer as TVisualizer

HW = 16
# Every op of the augmentation pipeline, the anti-aliased resize included.
ALL_OPS = {
    "flip_param": {"time_flip": True, "horizontal_flip": True},
    "rotation_param": {"degrees": 15},
    "resize_param": {"ratio": [0.6, 1.2]},
    "crop_param": {"size": [HW, HW]},
    "jitter_param": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0.1},
}


def _video(seed, t=6):
    return np.random.RandomState(seed).rand(t, HW, HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    for split, n in (("train", 10), ("test", 2)):
        os.makedirs(root / split)
        for i in range(n):
            write_stacked_png(str(root / split / f"{i:03d}.png"), _video(i, t=4 + i % 3))
    return str(root)


# ---- decode ------------------------------------------------------------------

def test_decode_video_reports_the_native_reader(root):
    """The port builds native/monkeynet_io.cpp into its own build directory
    and decodes with it; the pixels are the JAX package's."""
    path = os.path.join(root, "train", "001.png")
    video, reader = decode_video(path, (HW, HW, 3))
    if not jnative.available():
        pytest.skip("no C++ toolchain with libpng here")
    assert reader == "native"
    assert tnative.library_path().parent == tnative.BUILD_DIR
    np.testing.assert_array_equal(video, jread_video(path, (HW, HW, 3)))
    np.testing.assert_allclose(video, _video(1, t=5), atol=1 / 255 + 1e-6)


def test_decode_video_falls_back_to_pillow(root, tmp_path, monkeypatch):
    """Without the native library Pillow decodes the pixels of the JAX
    package's imageio path and says so (the native decoder multiplies by
    1/255, an ulp off the quotient): stacked PNGs, a 128^2-frame file read
    at 64^2, and gifs."""
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    path = os.path.join(root, "train", "002.png")
    video, reader = decode_video(path, (HW, HW, 3))
    assert reader == "pillow"
    np.testing.assert_array_equal(video, jread_video(path, (HW, HW, 3)))
    np.testing.assert_allclose(video, _video(2, t=6), atol=1 / 255 + 1e-6)
    big = str(tmp_path / "big.png")
    write_stacked_png(big, np.random.RandomState(4).rand(3, 2 * HW, 2 * HW, 3))
    np.testing.assert_array_equal(read_video(big, (HW, HW, 3)), jread_video(big, (HW, HW, 3)))
    gif = str(tmp_path / "v.gif")
    write_gif(gif, _video(3, t=3))
    video, reader = decode_video(gif)
    assert reader == "pillow" and video.shape == (3, HW, HW, 3)
    np.testing.assert_array_equal(video, jread_video(gif))


# ---- dataset and loader --------------------------------------------------------

def _batches(loader_cls, dataset_cls, root, augmentation, postprocess, cache, num_workers):
    dataset = dataset_cls(root_dir=root, image_shape=(HW, HW, 3), is_train=True,
                          augmentation_params=augmentation, cache_videos=cache)
    # the JAX loader's defaults, shuffle=True and drop_last=True, are the
    # port's only behaviour
    loader = loader_cls(dataset, batch_size=3, num_workers=num_workers, seed=5,
                        postprocess=postprocess)
    loader.epoch = 1
    return list(loader.stream(2))


@pytest.mark.parametrize("feed", ["float32", "uint8", "uint8_cached"])
def test_stream_matches_jax(root, feed):
    """Two epochs of DataLoader.stream for one seed: the same epochs, names
    and pixels as the JAX package's, exactly, with every augmentation op, in
    the float feed and through quantize_feed (and the uint8 video cache)."""
    quantize = feed != "float32"
    cache = feed == "uint8_cached"
    want = _batches(JDataLoader, JFramesDataset, root, ALL_OPS,
                    jquantize_feed if quantize else None, cache, 1)
    got = _batches(TDataLoader, TFramesDataset, root, ALL_OPS,
                   tquantize_feed if quantize else None, cache, 3)
    assert [ep for ep, _ in got] == [ep for ep, _ in want] == [1] * 3 + [2] * 3
    for (_, g), (_, w) in zip(got, want):
        assert g["name"] == w["name"]
        assert set(g) == set(w) == {"name", "source", "video"}
        for key in ("source", "video"):
            assert g[key].dtype == (np.uint8 if quantize else np.float32)
            np.testing.assert_array_equal(g[key], w[key])
    assert [b["name"] for _, b in got[:3]] != [b["name"] for _, b in got[3:]]


def test_test_split_and_random_split_match_jax(root, tmp_path):
    for is_train in (True, False):
        got = TFramesDataset(root_dir=root, image_shape=(HW, HW, 3), is_train=is_train)
        want = JFramesDataset(root_dir=root, image_shape=(HW, HW, 3), is_train=is_train)
        assert got.images == want.images and len(got) == len(want)
    np.testing.assert_array_equal(got[1]["video"], want[1]["video"])
    flat = tmp_path / "flat"
    flat.mkdir()
    for i in range(10):
        write_stacked_png(str(flat / f"{i:02d}.png"), _video(i, t=2))
    for is_train in (True, False):
        assert TFramesDataset(root_dir=str(flat), is_train=is_train).images == \
            JFramesDataset(root_dir=str(flat), is_train=is_train).images


# ---- the feeder ------------------------------------------------------------------

def _numbered(n, fail_at=None, closed=None):
    try:
        for i in range(n):
            if i == fail_at:
                raise ValueError(f"batch {i} is broken")
            yield i // 2, {"source": np.full((2, 1, 2, 2, 3), i, np.float32),
                           "video": np.full((2, 1, 2, 2, 3), 255 - i, np.uint8), "name": ["a", "b"]}
    finally:
        if closed is not None:
            closed.set()


def test_device_prefetch_stages_every_batch_in_order():
    feed = DevicePrefetch(_numbered(5), "cpu")
    seen = []
    for ep, batch, staged in feed:
        assert set(staged) == {"source", "video"}
        for key in staged:
            assert isinstance(staged[key], torch.Tensor)
            np.testing.assert_array_equal(staged[key].numpy(), batch[key])
        seen.append((ep, int(staged["source"][0, 0, 0, 0, 0])))
    assert seen == [(0, 0), (0, 1), (1, 2), (1, 3), (2, 4)]
    assert feed.wait_s >= 0


def test_device_prefetch_reraises_and_stops():
    """A failing batch re-raises in the consumer; leaving the loop early
    stops the feeder and closes the stream."""
    with pytest.raises(ValueError, match="batch 2 is broken"):
        for _ in DevicePrefetch(_numbered(5, fail_at=2), "cpu"):
            pass
    closed = threading.Event()
    it = iter(DevicePrefetch(_numbered(100, closed=closed), "cpu", depth=1))
    next(it)
    it.close()
    assert closed.wait(timeout=10)


# ---- logger, visualizer, checkpoints ------------------------------------------------

def _vis_inputs(seed):
    rng = np.random.RandomState(seed)
    inp = {"source": rng.rand(2, 1, HW, HW, 3).astype(np.float32),
           "video": rng.rand(2, 1, HW, HW, 3).astype(np.float32)}
    out = {"video_prediction": rng.rand(2, 1, HW, HW, 3).astype(np.float32),
           "video_deformed": rng.rand(2, 1, HW, HW, 3).astype(np.float32),
           "kp_driving": {"mean": rng.rand(2, 1, 3, 2).astype(np.float32) * 2 - 1},
           "kp_source": {"mean": rng.rand(2, 1, 3, 2).astype(np.float32) * 2 - 1}}
    return inp, out


def test_keypoint_colours_match_matplotlib():
    """The port's gist_rainbow table is matplotlib's, entry for entry, at
    every k / K the Visualizer asks for and across [0, 1]."""
    import matplotlib.pyplot as plt

    want = plt.get_cmap("gist_rainbow")
    got = TVisualizer().colormap
    for x in [k / n for n in range(1, 21) for k in range(n)] + list(np.linspace(0, 1, 513)):
        assert got(x) == tuple(want(x)), x
    with pytest.raises(ValueError, match="gist_rainbow"):
        TVisualizer(colormap="viridis")


def test_visualizer_matches_jax():
    inp, out = _vis_inputs(0)
    params = {"kp_size": 2, "draw_border": True, "colormap": "gist_rainbow"}
    got = TVisualizer(**params).visualize_reconstruction(inp, out)
    np.testing.assert_array_equal(got, JVisualizer(**params).visualize_reconstruction(inp, out))
    assert got.dtype == np.uint8 and got.shape == (1, 2 * HW, 5 * HW, 3)


def test_logger_matches_jax(tmp_path):
    """The same values give the JAX Logger's log.txt lines (steps/s aside),
    gifs at the log boundaries and checkpoints at the epochs that hit
    cpk_freq_epoch and on exit."""
    names = ["rec", "gen_gan", "disc_gan"]
    rows = np.random.RandomState(1).rand(7, 3).astype(np.float32)
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for kind, cls in (("jax", JLogger), ("port", TLogger)):
        os.makedirs(dirs[kind])
        with cls(str(dirs[kind]), log_freq_iter=3, cpk_freq_epoch=2,
                 visualizer_params={"kp_size": 1}) as logger:
            for it, row in enumerate(rows):
                values = row if kind == "jax" else torch.from_numpy(row)
                if kind == "jax":
                    logger.log_iter(it, names, values, *_vis_inputs(it))
                else:
                    logger.log_iter(it, names, values, vis=lambda it=it: _vis_inputs(it))
                if it % 2 == 1:
                    logger.log_epoch(it // 2, {"w": torch.full((2,), float(it))})
    lines = {kind: [line.rsplit("; steps/s", 1)[0]
                    for line in (d / "log.txt").read_text().splitlines()]
             for kind, d in dirs.items()}
    assert lines["port"] == lines["jax"]
    assert lines["port"][1].startswith("00000003) rec - ")
    for kind in dirs:
        assert sorted(os.listdir(dirs[kind] / "train-vis")) == \
            ["00000000-rec.gif", "00000003-rec.gif", "00000006-rec.gif"]
    assert sorted(f for f in os.listdir(dirs["port"]) if "checkpoint" in f) == \
        [checkpoint_name(0), checkpoint_name(2)]
    last = load_checkpoint(str(dirs["port"] / checkpoint_name(2)))
    # epoch 2 is written when it ends (it 5) and again on exit (it 6)
    assert last["epoch"] == 2 and last["it"] == 6 and last["w"].tolist() == [5.0, 5.0]


def test_checkpoint_round_trip_and_atomic_write(tmp_path):
    path = str(tmp_path / checkpoint_name(3))
    assert checkpoint_name(3) == "00000003-checkpoint.pth.tar"
    payload = {"generator": {"w": torch.arange(4.0)}, "epoch": 3, "it": 17}
    save_checkpoint(path, payload)
    assert os.listdir(tmp_path) == [checkpoint_name(3)]
    back = load_checkpoint(path)
    assert back["epoch"] == 3 and back["it"] == 17
    assert torch.equal(back["generator"]["w"], payload["generator"]["w"])


def test_prepare_log_dir_matches_jax(tmp_path):
    config = tmp_path / "shapes.yaml"
    config.write_text("a: 1\n")
    resume = tmp_path / "run" / "00000001-checkpoint.pth.tar"
    got = tprepare_log_dir(str(config), str(tmp_path / "log"), str(resume))
    assert got == jprepare_log_dir(str(config), str(tmp_path / "log"), str(resume))
    assert (tmp_path / "run" / "shapes.yaml").read_text() == "a: 1\n"
    fresh = tprepare_log_dir(str(config), str(tmp_path / "log"), None)
    assert os.path.basename(fresh).startswith("shapes ") and os.path.isdir(fresh)


def test_async_writer_reraises_a_failed_job():
    done = []
    writer = AsyncWriter()
    writer.submit(lambda: done.append(1))
    writer.flush()
    writer.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        writer.close()
    assert done == [1]
