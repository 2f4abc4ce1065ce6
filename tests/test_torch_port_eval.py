"""The PyTorch port's eval modes held against the JAX package on the CPU:
keypoint normalisation, transfer pairs, KPExtractor, the metrics and their
embedder, reconstruction() and transfer() (both routes), the checkpoint
reader, the CLI and the demo.

One `.pth.tar`, written by the port from the JAX package's weights
(`from_jax_variables`), drives both packages' drivers: the JAX package reads
it through its `load_any`. The frames are random 32^2 stacked PNGs written
to a temp dir; the model is tests/torch_port_common.py's tiny config.

Both drivers run in f32 (the JAX TransferEngine's bf16 cast of the source
keypoints does not arise). Tolerances: keypoint means 1e-5 and covariances
1e-4 (test_torch_port_models.py's); normalised keypoints 1e-4, since the
hull's area ratio and the covariance's inverse and eigendecomposition
amplify those gaps a few times; L1 1e-5 relative; AKD 1e-3 px; embeddings
and AED 1e-4 relative; written PNG frames within one unit of 1/255.
"""

from __future__ import annotations

import csv
import itertools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import monkeynet_tpu.tasks.build as jbuild
import monkeynet_tpu.tasks.reconstruction as jrecon
from monkeynet_tpu.data.dataset import FramesDataset as JFramesDataset
from monkeynet_tpu.data.dataset import PairedDataset as JPairedDataset
from monkeynet_tpu.models.blocks import Encoder as JEncoder
from monkeynet_tpu.tasks import animate as janimate
from monkeynet_tpu.tasks import metrics as jmetrics
from monkeynet_tpu.tasks import transfer as jtransfer
from monkeynet_tpu_torch.data.dataset import FramesDataset as TFramesDataset
from monkeynet_tpu_torch.data.dataset import PairedDataset as TPairedDataset
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.tasks import animate as tanimate
from monkeynet_tpu_torch.tasks import metrics as tmetrics
from monkeynet_tpu_torch.tasks import prediction as tpred
from monkeynet_tpu_torch.tasks import reconstruction as trecon
from monkeynet_tpu_torch.tasks import transfer as ttransfer
from monkeynet_tpu_torch.utils.checkpoint import save_checkpoint
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import H, W, init_models_once, jax_variables, port_models, tiny_config

FRAMES = 5
KP_ATOL = {"mean": 1e-5, "var": 1e-4}
NORM_FLAGS = ("movement_mult", "move_location", "adapt_variance", "clip_mean")
HULL_RECIPE = dict.fromkeys(NORM_FLAGS, True)


def _write_videos(root, n_train=3, n_test=3):
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            rng = np.random.RandomState(100 * (split == "test") + i)
            video = rng.rand(FRAMES, H, W, 3).astype(np.float32)
            write_stacked_png(os.path.join(root, split, f"{split}{i:02d}.png"), video)


def _config(root):
    config = tiny_config()
    config["dataset_params"] = {"root_dir": root, "image_shape": [H, W, 3]}
    config["reconstruction_params"] = {"num_videos": 1, "format": ".gif"}
    config["transfer_params"] = {"num_pairs": 2, "format": ".gif",
                                 "normalization_params": {"move_location": True}}
    config["visualizer_params"] = {"kp_size": 1, "draw_border": True}
    return config


def _frozen_jax_variables(config):
    """The JAX package's frozen AED embedder weights, drawn as its
    EmbeddingExtractor draws them."""
    gp = config["model_params"]["generator_params"]
    encoder = JEncoder(gp["block_expansion"], num_blocks=gp["num_blocks"],
                       max_features=gp["max_features"])
    dummy = jnp.zeros((1, 1, H, W, 3), jnp.float32)
    return jax.jit(lambda r: encoder.init(r, dummy, False))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Weights, models, the checkpoint and both packages' datasets; the JAX
    init_models runs once for the module."""
    root = str(tmp_path_factory.mktemp("videos"))
    _write_videos(root)
    config = _config(root)
    with pytest.MonkeyPatch.context() as mp:
        init_models = init_models_once()
        mp.setattr(jbuild, "init_models", init_models)
        mp.setattr(jrecon, "init_models", init_models)
        models, params, batch_stats = jax_variables(config)
        generator, kp_detector = port_models(config, params, batch_stats)
        ckpt = str(tmp_path_factory.mktemp("ckpt") / "weights.pth.tar")
        save_checkpoint(ckpt, {"generator": generator.state_dict(),
                               "kp_detector": kp_detector.state_dict()})
        frozen = _frozen_jax_variables(config)
        yield {
            "root": root, "config": config, "models": models, "ckpt": ckpt,
            "gen_vars": {"params": params["generator"],
                         "batch_stats": batch_stats["generator"]},
            "kp_vars": {"params": params["kp_detector"],
                        "batch_stats": batch_stats["kp_detector"]},
            "generator": generator, "kp_detector": kp_detector,
            "frozen_port": from_jax_variables(frozen["params"], frozen["batch_stats"]),
            "jax_test": JFramesDataset(is_train=False, **config["dataset_params"]),
            "port_test": TFramesDataset(is_train=False, **config["dataset_params"]),
            "tmp": tmp_path_factory,
        }


def _assert_kp_close(got, want, atol=None):
    assert set(got) == set(want)
    for k in want:
        tol = atol if atol is not None else KP_ATOL[k]
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=tol,
                                   rtol=tol, err_msg=k)


def _pngs(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        out[name] = np.asarray(Image.open(os.path.join(directory, name)).convert("RGB"))
    return out


def _assert_outputs_match(jax_dir, port_dir):
    """The same files; every PNG frame within one unit of 1/255."""
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    want, got = _pngs(os.path.join(jax_dir, "png")), _pngs(os.path.join(port_dir, "png"))
    assert list(got) == list(want) and want
    for name in want:
        gap = np.abs(got[name].astype(int) - want[name].astype(int)).max()
        assert gap <= 1, f"{name}: frames differ by {gap}/255"


# ---- keypoint normalisation -------------------------------------------------

def _normalize_inputs(seed=0, D=6, K=5):
    rng = np.random.RandomState(seed)

    def kp(d):
        a = rng.randn(1, d, K, 2, 2).astype(np.float32) * 0.1
        return {"mean": (rng.rand(1, d, K, 2) * 1.6 - 0.8).astype(np.float32),
                "var": (a @ np.swapaxes(a, -1, -2) + 0.01 * np.eye(2, dtype=np.float32))}

    return kp(D), kp(1)


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=4)),
                         ids=lambda f: "-".join(n for n, on in zip(NORM_FLAGS, f) if on) or "none")
def test_normalize_kp_matches_jax(flags):
    """All 16 recipes, exact to f32 rounding: both are the same numpy."""
    kp_video, kp_appearance = _normalize_inputs()
    opts = dict(zip(NORM_FLAGS, flags))
    want = jtransfer.normalize_kp(kp_video, kp_appearance, **opts)
    got = ttransfer.normalize_kp(kp_video, kp_appearance, **opts)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    # the inputs are not modified
    np.testing.assert_array_equal(kp_video["mean"], _normalize_inputs()[0]["mean"])


def test_make_symmetric_psd_matches_jax():
    """Symmetric, with a non-positive eigenvalue clamped to 1e-6."""
    rng = np.random.RandomState(1)
    mats = rng.randn(2, 7, 4, 2, 2).astype(np.float32)
    got = ttransfer.make_symmetric_psd(mats)
    np.testing.assert_allclose(got, jtransfer.make_symmetric_psd(mats), rtol=1e-6, atol=1e-7)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.swapaxes(got, -1, -2), atol=1e-6)
    assert (np.linalg.eigvalsh(got.astype(np.float64)) > 0).all()


# ---- transfer pairs ---------------------------------------------------------

@pytest.mark.parametrize("num_pairs", [2, 3, 50])
def test_paired_dataset_grid_matches_jax(shared, num_pairs):
    want = JPairedDataset(shared["jax_test"], num_pairs)
    got = TPairedDataset(shared["port_test"], num_pairs)
    assert [tuple(map(int, p)) for p in got.pairs] == [tuple(map(int, p)) for p in want.pairs]
    x, y = got[0], want[0]
    assert set(x) == set(y)
    assert x["driving_name"] == y["driving_name"] and x["source_name"] == y["source_name"]
    np.testing.assert_allclose(x["driving_video"], y["driving_video"], atol=1e-7)


def test_paired_dataset_pairs_list_matches_jax(shared, tmp_path):
    """A CSV pairs list: rows naming a missing video are dropped, the first
    `number_of_pairs` of the rest taken in order."""
    names = shared["port_test"].images
    rows = [(names[0], names[1]), ("missing.png", names[0]), (names[2], names[0]),
            (names[1], "gone.png"), (names[1], names[2]), (names[0], names[0])]
    path = tmp_path / "pairs.csv"
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["source", "driving"])
        writer.writerows(rows)
    params = dict(shared["config"]["dataset_params"], pairs_list=str(path))
    jds = JFramesDataset(is_train=False, **params)
    tds = TFramesDataset(is_train=False, **params)
    for n in (2, 10):
        want = JPairedDataset(jds, n).pairs
        got = TPairedDataset(tds, n).pairs
        assert [tuple(map(int, p)) for p in got] == [tuple(map(int, p)) for p in want]
    assert len(TPairedDataset(tds, 10)) == 4


def test_visualize_transfer_matches_jax():
    """The transfer grid (source, driving first frame, driving, prediction
    with the normalised keypoints, prediction, deformed), byte for byte."""
    from monkeynet_tpu.utils.visualizer import Visualizer as JVisualizer
    from monkeynet_tpu_torch.utils.visualizer import Visualizer as TVisualizer

    rng = np.random.RandomState(12)
    D, K = 3, 4

    def kp(d):
        return {"mean": (rng.rand(1, d, K, 2) * 2 - 1).astype(np.float32)}

    driving = rng.rand(1, D, H, W, 3).astype(np.float32)
    source = rng.rand(1, 1, H, W, 3).astype(np.float32)
    out = {"video_prediction": rng.rand(1, D, H, W, 3).astype(np.float32),
           "video_deformed": rng.rand(1, D, H, W, 3).astype(np.float32),
           "kp_driving": kp(D), "kp_source": kp(1), "kp_norm": kp(D)}
    params = {"kp_size": 2, "draw_border": True}
    got = TVisualizer(**params).visualize_transfer(driving, source, out)
    np.testing.assert_array_equal(got, JVisualizer(**params).visualize_transfer(driving, source,
                                                                                out))
    assert got.dtype == np.uint8 and got.shape == (D, H, 6 * W, 3)


# ---- KPExtractor --------------------------------------------------------------

def test_kp_extractor_matches_jax(shared):
    """20 frames in chunks of 16: a full chunk and a 4-frame tail padded to
    a 16-frame bucket; numpy from __call__, f32 tensors from device_call."""
    video = np.random.RandomState(3).rand(1, 20, H, W, 3).astype(np.float32)
    want = janimate.KPExtractor(shared["models"]["kp_detector"], shared["kp_vars"],
                                chunk=16)(video)
    extractor = tanimate.KPExtractor(shared["kp_detector"], chunk=16, device="cpu")
    got = extractor(video)
    assert all(isinstance(v, np.ndarray) and v.shape[1] == 20 for v in got.values())
    _assert_kp_close(got, want)
    on_device = extractor.device_call(torch.from_numpy(video))
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in on_device.values())
    _assert_kp_close({k: v.numpy() for k, v in on_device.items()}, got, atol=0)


def test_kp_extractor_refuses_missing_cuda(shared, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tanimate.KPExtractor(shared["kp_detector"])


# ---- metrics ------------------------------------------------------------------

def test_akd_and_kp_to_pixels_match_jax():
    rng = np.random.RandomState(4)
    gt = {"mean": (rng.rand(1, 6, 4, 2) * 2 - 1).astype(np.float32)}
    pred = {"mean": (rng.rand(1, 6, 4, 2) * 2 - 1).astype(np.float32)}
    for shape in ((32, 32), (48, 64, 3)):
        np.testing.assert_allclose(tmetrics.kp_to_pixels(gt["mean"], shape),
                                   jmetrics.kp_to_pixels(gt["mean"], shape), rtol=1e-7)
        assert tmetrics.akd(gt, pred, shape) == pytest.approx(jmetrics.akd(gt, pred, shape),
                                                              rel=1e-7)
    # a keypoint on pixel p maps back to exactly p
    np.testing.assert_allclose(tmetrics.kp_to_pixels(np.array([[-1.0, 1.0]]), (5, 9)),
                               [[0.0, 4.0]])


def test_aed_matches_jax():
    rng = np.random.RandomState(5)
    a, b = rng.randn(1, 6, 16).astype(np.float32), rng.randn(1, 6, 16).astype(np.float32)
    assert tmetrics.aed(a, b) == pytest.approx(jmetrics.aed(a, b), rel=1e-7)


@pytest.mark.parametrize("embedder", ["frozen", "appearance"])
def test_embedding_extractor_matches_jax(shared, embedder):
    """The frozen embedder at the JAX package's PRNGKey(0) weights carried
    across, and the generator's appearance encoder; 7 frames in chunks of 4."""
    config = shared["config"]
    video = np.random.RandomState(6).rand(1, 7, H, W, 3).astype(np.float32)
    want = jmetrics.EmbeddingExtractor(config, shared["gen_vars"], chunk=4,
                                       embedder=embedder)(video)
    got = tmetrics.EmbeddingExtractor(config, shared["generator"], chunk=4, embedder=embedder,
                                      variables=shared["frozen_port"], device="cpu")(video)
    assert got.shape == want.shape == (1, 7, config["model_params"]["generator_params"]
                                       ["max_features"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_embedding_extractor_draws_its_own_frozen_weights(shared, capsys):
    """Without weights the frozen embedder is drawn at torch seed 0, the same
    every time, and says that its AED compares only across port runs."""
    config = shared["config"]
    video = np.random.RandomState(7).rand(1, 3, H, W, 3).astype(np.float32)
    first = tmetrics.EmbeddingExtractor(config, device="cpu")(video)
    second = tmetrics.EmbeddingExtractor(config, device="cpu")(video)
    np.testing.assert_array_equal(first, second)
    assert "only across runs of the port" in capsys.readouterr().out
    with pytest.raises(ValueError, match="requires the generator"):
        tmetrics.EmbeddingExtractor(config, embedder="appearance", device="cpu")
    with pytest.raises(ValueError, match="unknown AED embedder"):
        tmetrics.EmbeddingExtractor(config, embedder="facenet", device="cpu")


# ---- the drivers ----------------------------------------------------------------

def _run_both(shared, name, jax_fn, port_fn, config):
    jax_dir = str(shared["tmp"].mktemp(f"jax_{name}"))
    port_dir = str(shared["tmp"].mktemp(f"port_{name}"))
    with pytest.MonkeyPatch.context() as mp:
        init_models = init_models_once()
        mp.setattr(jbuild, "init_models", init_models)
        mp.setattr(jrecon, "init_models", init_models)
        want = jax_fn(config, jax_dir, shared["jax_test"], shared["ckpt"])
    got = port_fn(config, port_dir, shared["port_test"], shared["ckpt"])
    return jax_dir, port_dir, want, got


@pytest.fixture(scope="module")
def reconstructed(shared):
    return _run_both(
        shared, "reconstruction", jrecon.reconstruction,
        lambda *a: trecon.reconstruction(*a, device="cpu", aed_variables=shared["frozen_port"]),
        shared["config"])


def test_reconstruction_matches_jax(reconstructed):
    """num_videos 1: two videos (the reference's `it > num_videos` bound);
    the same metrics and the same files, frame for frame."""
    jax_dir, port_dir, want, got = reconstructed
    assert set(got) == set(want) == {"l1", "akd", "aed"}
    assert got["l1"] == pytest.approx(want["l1"], rel=1e-5)
    assert got["akd"] == pytest.approx(want["akd"], abs=1e-3)
    assert got["aed"] == pytest.approx(want["aed"], rel=1e-4)
    assert all(np.isfinite(v) for v in got.values())
    _assert_outputs_match(os.path.join(jax_dir, "reconstruction"),
                          os.path.join(port_dir, "reconstruction"))
    assert len(os.listdir(os.path.join(port_dir, "reconstruction", "png"))) == 2


@pytest.mark.parametrize("recipe", ["move_location", "hull_and_covariance"])
def test_transfer_matches_jax(shared, recipe):
    """The TransferEngine route (move_location) and the host route
    (KPExtractor, normalize_kp with the convex hull and the covariance,
    Animator): the same pairs, files and frames."""
    config = dict(shared["config"])
    norm = {"move_location": True} if recipe == "move_location" else HULL_RECIPE
    config["transfer_params"] = dict(config["transfer_params"], normalization_params=norm)
    jax_dir, port_dir, _, written = _run_both(
        shared, recipe, jtransfer.transfer,
        lambda *a: ttransfer.transfer(*a, device="cpu"), config)
    assert written == 2
    _assert_outputs_match(os.path.join(jax_dir, "transfer"), os.path.join(port_dir, "transfer"))


def test_transfer_one_matches_jax(shared):
    """The host route's numbers: driving, source and normalised keypoints,
    and the animation from them."""
    driving = np.random.RandomState(8).rand(1, 6, H, W, 3).astype(np.float32)
    source = np.random.RandomState(9).rand(1, 1, H, W, 3).astype(np.float32)
    params = {"normalization_params": HULL_RECIPE}
    models = shared["models"]
    want = jtransfer.transfer_one(janimate.Animator(models["generator"], shared["gen_vars"]),
                                  janimate.KPExtractor(models["kp_detector"], shared["kp_vars"]),
                                  source, driving, params)
    got = ttransfer.transfer_one(tanimate.Animator(shared["generator"], device="cpu"),
                                 tanimate.KPExtractor(shared["kp_detector"], device="cpu"),
                                 source, driving, params)
    for group in ("kp_driving", "kp_source"):
        _assert_kp_close(got[group], want[group])
    _assert_kp_close(got["kp_norm"], want["kp_norm"], atol=1e-4)
    for key in ("video_prediction", "video_deformed"):
        assert isinstance(got[key], np.ndarray)
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=key)


def test_load_eval_models_reads_both_checkpoint_forms(shared, tmp_path):
    """A bare generator / kp_detector file, the train loop's checkpoint
    (with optimizer entries) and the JAX package's msgpack file of the same
    networks give the same weights."""
    config = shared["config"]
    bare_gen, bare_kp = trecon.load_eval_models(config, shared["ckpt"], device="cpu")
    payload = torch.load(shared["ckpt"], weights_only=True)
    train_ckpt = str(tmp_path / "00000000-checkpoint.pth.tar")
    save_checkpoint(train_ckpt, {**payload, "discriminator": {}, "optimizer_generator": {},
                                 "epoch": 0, "it": 0})
    gen, kp = trecon.load_eval_models(config, train_ckpt, device="cpu")
    assert not gen.training and not kp.training
    for a, b in ((gen, bare_gen), (kp, bare_kp)):
        for (key, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), key
    for key, value in payload["generator"].items():
        assert torch.equal(gen.state_dict()[key], value), key
    from monkeynet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    jax_ckpt = str(tmp_path / "00000000-checkpoint.msgpack")
    jax_save_checkpoint(jax_ckpt, {"generator": shared["gen_vars"],
                                   "kp_detector": shared["kp_vars"]})
    gen, kp = trecon.load_eval_models(config, jax_ckpt, device="cpu")
    for a, b in ((gen, bare_gen), (kp, bare_kp)):
        for (key, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), key


def test_eval_drivers_refuse_missing_checkpoint_cuda_and_devices(shared, tmp_path, monkeypatch):
    """Each eval driver refuses a missing checkpoint, and without a card
    refuses its default device rather than falling back to the CPU."""
    config, dataset = shared["config"], shared["port_test"]
    drivers = {"reconstruction": lambda ckpt, **kw: trecon.reconstruction(
                   config, str(tmp_path), dataset, ckpt, **kw),
               "transfer": lambda ckpt, **kw: ttransfer.transfer(
                   config, str(tmp_path), dataset, ckpt, **kw),
               "prediction": lambda ckpt, **kw: tpred.prediction(
                   config, str(tmp_path), ckpt, **kw)}
    for mode, run in drivers.items():
        with pytest.raises(ValueError, match=f"checkpoint is required for {mode} mode"):
            run(None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in drivers.values():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(shared["ckpt"])


# ---- the CLI and the demo ----------------------------------------------------

def _on_cpu(monkeypatch):
    """Answer the CLI's card check with the CPU device; the drivers it calls
    then get the CPU device passed in."""
    from monkeynet_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(device_mod, "require_device", lambda device: torch.device("cpu"))


@pytest.mark.parametrize("mode", ["reconstruction", "transfer"])
def test_cli_eval_modes(shared, tmp_path, monkeypatch, capsys, mode):
    """`python -m monkeynet_tpu_torch.run --mode reconstruction / transfer`
    with the card's check answered with the CPU: outputs beside the
    checkpoint, the config copied in; without a card it raises."""
    import shutil

    import yaml

    from monkeynet_tpu_torch import run

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(shared["config"]))
    ckpt = tmp_path / "run" / "weights.pth.tar"
    ckpt.parent.mkdir()
    shutil.copy(shared["ckpt"], ckpt)
    with monkeypatch.context() as mp:
        _on_cpu(mp)
        assert run.main(["--config", str(path), "--mode", mode, "--checkpoint", str(ckpt)]) == 0
    out = capsys.readouterr().out
    files = sorted(os.listdir(ckpt.parent / mode / "png"))
    assert "tiny.yaml" in os.listdir(ckpt.parent)
    if mode == "reconstruction":
        assert "Reconstruction loss:" in out and "AKD" in out and "AED" in out
        assert files == ["test00.png.png", "test01.png.png"]
    else:
        assert len(files) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--config", str(path), "--mode", mode, "--checkpoint", str(ckpt)])


def test_demo_matches_jax(shared, tmp_path, monkeypatch):
    """monkeynet_tpu_torch.demo.run_demo against the repository's demo.py on
    a 6-frame stacked driving PNG and a source image, both read at 32^2 (the
    bundled pair's format); the CLI writes the gif."""
    import demo as jdemo
    from monkeynet_tpu_torch import demo as tdemo

    driving = str(tmp_path / "driving.png")
    source = str(tmp_path / "source.png")
    write_stacked_png(driving, np.random.RandomState(10).rand(6, H, W, 3).astype(np.float32))
    write_stacked_png(source, np.random.RandomState(11).rand(2, H, W, 3).astype(np.float32))
    config = dict(shared["config"], transfer_params={
        "normalization_params": {"move_location": True, "adapt_variance": True}})
    with monkeypatch.context() as mp:
        init_models = init_models_once()
        mp.setattr(jbuild, "init_models", init_models)
        mp.setattr(jrecon, "init_models", init_models)
        want = jdemo.run_demo(config, shared["ckpt"], driving, source,
                              str(tmp_path / "jax.gif"), image_shape=(H, W))
    got = tdemo.run_demo(config, shared["ckpt"], driving, source, str(tmp_path / "port.gif"),
                         image_shape=(H, W), device="cpu")
    np.testing.assert_allclose(got["video_prediction"], want["video_prediction"], atol=1e-4)
    gif = Image.open(tmp_path / "port.gif")
    assert gif.n_frames == 6 and gif.size == (W, H)

    import yaml

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(config))
    with monkeypatch.context() as mp:
        _on_cpu(mp)
        assert tdemo.main(["--config", str(path), "--checkpoint", shared["ckpt"],
                           "--driving_video", driving, "--source_image", source,
                           "--out_file", str(tmp_path / "cli.gif"),
                           "--image_shape", f"{H},{W}"]) == 0
    assert Image.open(tmp_path / "cli.gif").n_frames == 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdemo.run_demo(config, shared["ckpt"], driving, source, str(tmp_path / "x.gif"),
                       image_shape=(H, W))
