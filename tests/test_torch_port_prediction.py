"""The PyTorch port's prediction mode held against the JAX package on the
CPU: the GRU keypoint predictor, its training (per-epoch losses and the
plateau's rates), the loader's ordered walk, prediction() as a whole and
the CLI's prediction mode.

The predictor's weights are the JAX package's initial ones carried across
with `from_jax_variables` (gru{l} -> nn.GRU's `*_l{l}`, the head
transposed); the eval models come from one `.pth.tar` the port wrote from
the JAX package's weights, as in test_torch_port_eval.py.

Tolerances (f32 on both sides): the predictor's forward 1e-5 (a GRU
of 16 features over 8 frames, summed in another order); per-epoch losses
1e-4 relative, since Adam carries the forward's rounding from epoch to
epoch; the rates exactly; the rollout's PNG frames within one unit of
1/255.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import monkeynet_tpu.tasks.build as jbuild
import monkeynet_tpu.tasks.prediction as jpred
import monkeynet_tpu.tasks.reconstruction as jrecon
from monkeynet_tpu.data.loader import DataLoader as JDataLoader
from monkeynet_tpu.models.prediction import KeypointPredictor as JKeypointPredictor
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.data.loader import DataLoader as TDataLoader
from monkeynet_tpu_torch.models.prediction import KeypointPredictor
from monkeynet_tpu_torch.tasks import prediction as tpred
from monkeynet_tpu_torch.utils.checkpoint import save_checkpoint
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import H, W, init_models_once, jax_variables, port_models, tiny_config

FRAMES = 6
NUM_KP = 4
PREDICTION_PARAMS = {
    "rnn_params": {"num_features": 16, "num_layers": 1, "dropout": 0},
    "predict_variance": True,
    "num_epochs": 3,
    "lr": 0.001,
    "batch_size": 2,
    "num_frames": 4,
    "init_frames": 1,
    "train_size": 2,
    "format": ".gif",
}


def _kp_sequences(n, T, K=NUM_KP, seed=0, with_var=True):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kp = {"mean": np.tanh(np.cumsum(rng.randn(T, K, 2) * 0.1, axis=0)).astype(np.float32)}
        if with_var:
            a = rng.randn(T, K, 2, 2).astype(np.float32) * 0.1
            kp["var"] = a @ np.swapaxes(a, -1, -2) + 0.01 * np.eye(2, dtype=np.float32)
        out.append(kp)
    return out


def _jax_init(jmodel, batch, seed=0):
    return jmodel.init(jax.random.PRNGKey(seed),
                       {k: jnp.asarray(v) for k, v in batch.items()})["params"]


def _port_predictor(params, **kwargs):
    predictor = KeypointPredictor(**kwargs)
    predictor.load_state_dict(from_jax_variables(params, {}))
    return predictor


# ---- the predictor ----------------------------------------------------------

@pytest.mark.parametrize("with_var, num_layers", [(True, 1), (False, 1), (True, 2)])
def test_keypoint_predictor_matches_jax(with_var, num_layers):
    """mean then var flattened per frame, the head's output reshaped
    (B, D, K, -1), tanh on the first two, var = v^T v; the weights carried
    across by from_jax_variables."""
    seqs = _kp_sequences(3, 8, with_var=with_var)
    batch = {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}
    kwargs = dict(num_kp=NUM_KP, kp_variance="matrix" if with_var else 0.01,
                  num_features=16, num_layers=num_layers, dropout=0.0)
    jmodel = JKeypointPredictor(**kwargs)
    params = _jax_init(jmodel, batch)
    want = jmodel.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    predictor = _port_predictor(params, **kwargs)
    assert set(predictor.state_dict()) == set(from_jax_variables(params, {}))
    with torch.no_grad():
        got = predictor({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == ({"mean", "var"} if with_var else {"mean"})
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_build_predictor_is_seeded():
    config = {"model_params": {"common_params": {"num_kp": NUM_KP, "kp_variance": "matrix"}},
              "prediction_params": PREDICTION_PARAMS}
    a, b = tpred.build_predictor(config, seed=3), tpred.build_predictor(config, seed=3)
    c = tpred.build_predictor(config, seed=4)
    bound = 1 / 4  # 1 / sqrt(num_features)
    for (key, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                              c.state_dict().values()):
        assert torch.equal(x, y) and not torch.equal(x, z), key
        assert x.abs().max() <= bound
    assert a.gru.input_size == NUM_KP * 6 and a.head.out_features == NUM_KP * 6


# ---- the loader's ordered walk and the plateau ---------------------------------

class _RandomItems:
    """Items that depend on the RNG the loader hands them."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        return {"x": np.full(3, idx, np.float32) + rng.random(3).astype(np.float32)}


@pytest.mark.parametrize("shuffle, drop_last", [(False, False), (True, False), (False, True)])
def test_dataloader_walks_match_jax(shuffle, drop_last):
    """7 items in batches of 3 over two epochs: the same batches, the
    per-item RNG included; the ordered walk keeps the last batch of 1."""
    kwargs = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=5)
    jloader, tloader = JDataLoader(_RandomItems(7), **kwargs), TDataLoader(_RandomItems(7),
                                                                            **kwargs)
    assert len(tloader) == len(jloader) == (2 if drop_last else 3)
    for _ in range(2):
        want, got = list(jloader), list(tloader)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["x"], b["x"])
    if not shuffle and not drop_last:
        assert [b["x"].shape[0] for b in got] == [3, 3, 1]
        assert [int(v) for v in np.concatenate([b["x"][:, 0] for b in got])] == list(range(7))


def test_reduce_lr_on_plateau_matches_jax():
    """0.49999 is no improvement on 0.5 (within the relative threshold): the
    rate falls on the third bad epoch after it, and again after 0.4."""
    losses = [1.0, 0.5, 0.5, 0.49999, 0.6, 0.7, 0.4, 0.4, 0.4, 0.4, 0.3]
    want, got = jpred.ReduceLROnPlateau(0.1, patience=2), tpred.ReduceLROnPlateau(0.1, patience=2)
    assert [got.step(x) for x in losses] == [want.step(x) for x in losses]
    assert got.lr == pytest.approx(1e-3)


# ---- train_predictor ----------------------------------------------------------

def _recording_plateau(module, record):
    """The module's plateau with patience 1 and a 30% threshold, so the rate
    falls within a few epochs, recording each epoch's loss and rate."""

    class Recording(module.ReduceLROnPlateau):
        def __init__(self, lr):
            super().__init__(lr, patience=1, threshold=0.3)

        def step(self, loss):
            record.append((loss, self.lr))
            return super().step(loss)

    return Recording


def test_train_predictor_matches_jax(monkeypatch):
    """8 epochs over 5 windows in batches of 2 (the last partial batch
    kept), from the JAX package's initial weights: the same loss every
    epoch and the same rate sequence, which falls twice."""
    params = dict(PREDICTION_PARAMS, num_epochs=8, lr=0.01, num_frames=6, init_frames=2)
    windows_j = jpred.KPSequenceDataset(_kp_sequences(5, 9), params["num_frames"])
    windows_t = tpred.KPSequenceDataset(_kp_sequences(5, 9), params["num_frames"])
    kwargs = dict(num_kp=NUM_KP, kp_variance="matrix", **params["rnn_params"])
    jmodel = JKeypointPredictor(**kwargs)
    init = _jax_init(jmodel, {k: v[None] for k, v in windows_j[0].items()})

    jrecord, trecord = [], []
    monkeypatch.setattr(jpred, "ReduceLROnPlateau", _recording_plateau(jpred, jrecord))
    monkeypatch.setattr(tpred, "ReduceLROnPlateau", _recording_plateau(tpred, trecord))
    jpred.train_predictor(jmodel, windows_j, params, seed=0)
    run = tpred.train_predictor(_port_predictor(init, **kwargs), windows_t, params, seed=0,
                                device="cpu")
    want_losses, want_lrs = zip(*jrecord)
    np.testing.assert_allclose(run.losses, want_losses, rtol=1e-4)
    assert run.lrs == list(want_lrs) == [rec[1] for rec in trecord]
    assert len(set(run.lrs)) == 3 and run.losses[-1] < run.losses[0]


# ---- prediction() ---------------------------------------------------------------

@pytest.fixture(scope="module")
def predicted(tmp_path_factory):
    """prediction() of both packages from one checkpoint, the port's
    predictor starting from the JAX package's initial weights."""
    root = str(tmp_path_factory.mktemp("videos"))
    for split, n in (("train", 4), ("test", 2)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            video = np.random.RandomState(10 * (split == "test") + i).rand(FRAMES, H, W, 3)
            write_stacked_png(os.path.join(root, split, f"{split}{i:02d}.png"),
                              video.astype(np.float32))
    config = tiny_config()
    config["dataset_params"] = {"root_dir": root, "image_shape": [H, W, 3]}
    config["prediction_params"] = copy.deepcopy(PREDICTION_PARAMS)
    config["visualizer_params"] = {"kp_size": 1, "draw_border": True}
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in ("jax", "port")}
    with pytest.MonkeyPatch.context() as mp:
        init_models = init_models_once()
        mp.setattr(jbuild, "init_models", init_models)
        mp.setattr(jrecon, "init_models", init_models)
        _, params, batch_stats = jax_variables(config)
        generator, kp_detector = port_models(config, params, batch_stats)
        ckpt = str(tmp_path_factory.mktemp("ckpt") / "weights.pth.tar")
        save_checkpoint(ckpt, {"generator": generator.state_dict(),
                               "kp_detector": kp_detector.state_dict()})
        jpred.prediction(config, dirs["jax"], ckpt)

        kwargs = dict(num_kp=NUM_KP, kp_variance="matrix",
                      **PREDICTION_PARAMS["rnn_params"])
        seqs = _kp_sequences(1, PREDICTION_PARAMS["num_frames"])
        init = _jax_init(JKeypointPredictor(**kwargs), {k: v[None] for k, v in seqs[0].items()})
        mp.setattr(tpred, "build_predictor", lambda config, seed: _port_predictor(init, **kwargs))
        result = tpred.prediction(config, dirs["port"], ckpt, device="cpu")
    return {"config": config, "dirs": dirs, "ckpt": ckpt, "result": result}


def test_prediction_matches_jax(predicted):
    """train_size 2: three train videos swept; the predictor trained 3
    epochs; both test videos rolled out and rendered, frame for frame."""
    result = predicted["result"]
    assert result["videos"] == 2 and len(result["losses"]) == 3
    assert result["lrs"] == [PREDICTION_PARAMS["lr"]] * 3
    jax_dir = os.path.join(predicted["dirs"]["jax"], "prediction")
    port_dir = os.path.join(predicted["dirs"]["port"], "prediction")
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "png", "test00.png.gif", "test01.png.gif"]
    for name in sorted(os.listdir(os.path.join(jax_dir, "png"))):
        want = np.asarray(Image.open(os.path.join(jax_dir, "png", name)).convert("RGB"))
        got = np.asarray(Image.open(os.path.join(port_dir, "png", name)).convert("RGB"))
        assert got.shape == want.shape == (H, W * PREDICTION_PARAMS["num_frames"], 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name
    gif = Image.open(os.path.join(port_dir, "test00.png.gif"))
    assert gif.n_frames == PREDICTION_PARAMS["num_frames"]


def test_predict_keypoints_keeps_the_initial_frames_and_variance():
    """The first init_frames frames are the input's; with predict_variance
    every frame takes the covariance of the last initial frame."""
    seqs = _kp_sequences(1, 5)
    kp_init = {k: v[None].copy() for k, v in seqs[0].items()}
    for k in kp_init:
        kp_init[k][:, 2:] = 0
    predictor = KeypointPredictor(num_kp=NUM_KP, kp_variance="matrix", num_features=8)
    params = dict(PREDICTION_PARAMS, init_frames=2)
    out = tpred.predict_keypoints(predictor, kp_init, params, "cpu")
    np.testing.assert_array_equal(out["mean"][:, :2], seqs[0]["mean"][None, :2])
    np.testing.assert_array_equal(out["var"], np.repeat(seqs[0]["var"][None, 1:2], 5, axis=1))
    assert np.abs(out["mean"][:, 2:]).max() > 0
    out = tpred.predict_keypoints(predictor, kp_init, dict(params, predict_variance=False),
                                  "cpu")
    assert not np.array_equal(out["var"][:, 2:], np.repeat(seqs[0]["var"][None, 1:2], 3, axis=1))


def test_cli_prediction_mode(predicted, tmp_path, monkeypatch, capsys):
    """`--mode prediction` with the card's check answered with the CPU; the
    checkpoint is required."""
    import shutil

    import yaml

    from monkeynet_tpu_torch import run
    from monkeynet_tpu_torch.utils import device as device_mod

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(predicted["config"]))
    ckpt = tmp_path / "run" / "weights.pth.tar"
    ckpt.parent.mkdir()
    shutil.copy(predicted["ckpt"], ckpt)
    with monkeypatch.context() as mp:
        mp.setattr(device_mod, "require_device", lambda device: torch.device("cpu"))
        assert run.main(["--config", str(path), "--mode", "prediction",
                         "--checkpoint", str(ckpt)]) == 0
        with pytest.raises(ValueError, match="checkpoint is required"):
            run.main(["--config", str(path), "--mode", "prediction",
                      "--log_dir", str(tmp_path / "log")])
    out = capsys.readouterr().out
    assert "Extracting keypoints..." in out and "Make predictions..." in out
    assert "in epoch 2; 2 test videos rendered" in out
    assert sorted(os.listdir(ckpt.parent / "prediction" / "png")) == [
        "test00.png.png", "test01.png.png"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--config", str(path), "--mode", "prediction", "--checkpoint", str(ckpt)])
