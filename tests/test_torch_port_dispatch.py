"""Several train steps a dispatch, remat and the chunked loop of the PyTorch
port, held against the JAX package on the CPU.

On the CPU `Trainer.run` takes its k steps eagerly (on the card it replays a
CUDA graph of the step, which chip_smoke.py holds against these eager
steps). Weights are made by the JAX package and copied into the port; the
config is the tiny one of tests/test_train.py (16^2 frames), batch 4.

Tolerances: the chunk's per-step metrics to 1e-4 relative and 1e-5
absolute, as one step of tests/test_torch_port_train.py (f32 on both sides,
other summation orders); after k SGD(1e-3) steps parameters to 1e-4 and
1e-5 as tests/test_train.py's k-step test, running statistics to 1e-5; one
SGD(1.0) remat step as test_torch_port_train.py's step (2e-4 of a tensor's
largest update); the train() log line to test_device_feed.py's 1e-3 and
1e-5.
"""

from __future__ import annotations

import copy
import os
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import monkeynet_tpu.tasks.build as jbuild
import monkeynet_tpu.tasks.train as jtrain
import monkeynet_tpu.tasks.train_loop as jloop
from monkeynet_tpu.data import augmentation as jaug
from monkeynet_tpu.data import device_feed as jfeed
from monkeynet_tpu.data.dataset import FramesDataset as JFramesDataset
from monkeynet_tpu.utils.logger import Logger as JLogger
from monkeynet_tpu_torch.data import augmentation as taug
from monkeynet_tpu_torch.data import device_feed as tfeed
from monkeynet_tpu_torch.data.dataset import FramesDataset as TFramesDataset
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.tasks import train as ttrain
from monkeynet_tpu_torch.tasks import train_loop as tloop
from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint, save_checkpoint
from monkeynet_tpu_torch.utils.logger import Logger as TLogger
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import init_models_once, jax_variables, port_train_models, train_config

HW = 16
B, K = 4, 3
N_VIDEOS, T = 4, 8
MODEL_NAMES = ttrain.MODEL_NAMES
PIPELINE = dict(
    flip_param={"time_flip": True, "horizontal_flip": True},
    rotation_param={"degrees": (-10, 10)},
    resize_param={"ratio": (0.9, 1.1)},
    crop_param={"size": (HW, HW)},
    jitter_param={"hue": 0.5},
)
LOG_LINE = re.compile(r"^(\d+)\) (.*); steps/s - [\d.na]+$")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    config = train_config()
    models, params, batch_stats = jax_variables(config, image_hw=(HW, HW))
    return config, models, params, batch_stats


def _port_trainer(shared, train_params, lr):
    config, _, params, batch_stats = shared
    return ttrain.Trainer(port_train_models(config, params, batch_stats), train_params,
                          device="cpu", optimizer_factory=lambda p: torch.optim.SGD(p, lr=lr))


def _jax_after(state):
    return {name: from_jax_variables(_np_tree(state.params[name]),
                                     _np_tree(state.batch_stats.get(name, {})))
            for name in MODEL_NAMES}


def _jax_state(shared, optimizer):
    _, _, params, batch_stats = shared
    return jtrain.create_train_state(jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, batch_stats), optimizer)


def _assert_states_close(trainer, want, steps, atol=1e-5, rtol=1e-4):
    for name in MODEL_NAMES:
        got = trainer.models[name].state_dict()
        assert set(got) == set(want[name])
        for key, w in want[name].items():
            g = got[key]
            if key.endswith("num_batches_tracked"):
                assert int(g) == steps, f"{name}.{key}"
                continue
            tol = 1e-5 if "running_" in key else atol
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5 if "running_" in key
                                       else rtol, atol=tol, err_msg=f"{name}.{key}")


def test_largest_divisor_leq_matches_jax():
    for n, k in [(4500, 32), (3750, 10), (64, 32), (12, 32), (997, 8), (5, 100), (1, 8),
                 (4, 32), (3200, 32), (96, 32)]:
        assert ttrain.largest_divisor_leq(n, k) == jtrain.largest_divisor_leq(n, k), (n, k)
    assert ttrain.largest_divisor_leq(4500, 32) == 30  # configs/actions.yaml


# ---- k steps a dispatch against the JAX scan ------------------------------------------

def _host_batches():
    rng = np.random.RandomState(1)
    return {k: rng.rand(K, B, 1, HW, HW, 3).astype(np.float32) for k in ("source", "video")}


def test_host_chunk_matches_jax_multi_step(shared):
    """Trainer.run over K stacked batches against make_multi_train_step's
    scan under SGD: every step's metrics, the visuals kept for the asked
    step only, and the final parameters and statistics."""
    tp = shared[0]["train_params"]
    batches = _host_batches()
    sgd = optax.sgd(1e-3)
    multi = jax.jit(jtrain.make_multi_train_step(shared[1], tp, sgd))
    state, want = multi(_jax_state(shared, sgd), {k: jnp.asarray(v) for k, v in batches.items()})
    trainer = _port_trainer(shared, tp, 1e-3)
    metrics, vis = trainer.run({k: torch.from_numpy(v) for k, v in batches.items()},
                               vis_steps=[1])
    assert metrics.shape == (K, len(ttrain.metric_names(tp)))
    np.testing.assert_allclose(metrics.numpy(), np.asarray(want["metrics"]), rtol=1e-4, atol=1e-5)
    assert sorted(vis) == [1]
    np.testing.assert_allclose(vis[1]["video_prediction"].numpy(),
                               np.asarray(want["video_prediction"][1]), atol=1e-4)
    np.testing.assert_allclose(vis[1]["kp_joined"]["mean"].numpy(),
                               np.asarray(want["kp_joined"]["mean"][1]), atol=1e-5)
    _assert_states_close(trainer, _jax_after(state), K)


def test_chunk_cut_in_two_matches_one_run(shared):
    """run(chunk, 0, 1) then run(chunk, 1, K) takes the same steps as one
    run over the chunk (the loop cuts a dispatch where a checkpoint is
    due)."""
    tp = shared[0]["train_params"]
    chunk = {k: torch.from_numpy(v) for k, v in _host_batches().items()}
    whole, parts = _port_trainer(shared, tp, 1e-3), _port_trainer(shared, tp, 1e-3)
    want, _ = whole.run(chunk)
    got = torch.cat([parts.run(chunk, 0, 1)[0], parts.run(chunk, 1, K)[0]])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for name in MODEL_NAMES:
        for key, value in whole.models[name].state_dict().items():
            assert torch.equal(parts.models[name].state_dict()[key], value), f"{name}.{key}"


@pytest.fixture(scope="module")
def videos():
    rng = np.random.default_rng(5)
    return (rng.random((N_VIDEOS, T, HW, HW, 3)) * 255).astype(np.uint8)


def test_device_feed_chunk_matches_jax_multi_step(shared, videos):
    """Trainer.run over K steps of augmentation plans, each step's batch made
    by the port's executor (actions.yaml's pipeline at 16^2), against
    make_multi_train_step(augment=make_device_augment) under SGD: the
    augmented batches of every step and the per-step metrics. The final
    parameters are pinned in two links, because the rotation's inputs differ
    by ~2e-6 between the packages and the kp detector's temperature-0.1
    softmax amplifies that ~3e3 times into the gradients: the port's steps
    over the JAX package's own augmented batches reach its parameters, and
    the device-fed run equals, bit for bit, the port's steps over the
    batches its executor made."""
    tp = shared[0]["train_params"]
    ttr = taug.AllAugmentationTransform(**PIPELINE)
    steps = [tfeed.collate_plans([(s + b) % N_VIDEOS for b in range(B)],
                                 [ttr.plan(T, HW, HW, np.random.default_rng((0, s, 0, b)))
                                  for b in range(B)])
             for s in range(K)]
    plans = {key: np.stack([p[key] for p in steps]) for key in steps[0]}
    sgd = optax.sgd(1e-3)
    jaugment = jfeed.make_device_augment(jaug.AllAugmentationTransform(**PIPELINE), (HW, HW, 3))
    multi = jax.jit(jtrain.make_multi_train_step(shared[1], tp, sgd, augment=jaugment))
    state, want = multi(_jax_state(shared, sgd),
                        {"videos": jnp.asarray(videos),
                         "plans": jax.tree.map(jnp.asarray, plans)})

    execute = tfeed.make_device_augment(ttr, (HW, HW, 3))
    cache = torch.from_numpy(videos)
    fed = _port_trainer(shared, tp, 1e-3)
    metrics, vis = fed.run({k: torch.from_numpy(v) for k, v in plans.items()},
                           vis_steps=range(K), augment=lambda plan: execute(cache, plan))
    np.testing.assert_allclose(metrics.numpy(), np.asarray(want["metrics"]), rtol=1e-4, atol=1e-5)
    assert sorted(vis) == list(range(K))
    for key in ("source", "video"):  # the augmented inputs of every step
        np.testing.assert_allclose(torch.stack([vis[j][key] for j in range(K)]).numpy(),
                                   np.asarray(want[key]), rtol=0, atol=5e-5)

    over_jax = _port_trainer(shared, tp, 1e-3)
    over_jax.run({k: torch.from_numpy(np.array(want[k])) for k in ("source", "video")})
    _assert_states_close(over_jax, _jax_after(state), K)
    over_own = _port_trainer(shared, tp, 1e-3)
    own_metrics, _ = over_own.run({k: torch.stack([vis[j][k] for j in range(K)])
                                   for k in ("source", "video")})
    torch.testing.assert_close(own_metrics, metrics, rtol=0, atol=0)
    for name in MODEL_NAMES:
        for key, value in over_own.models[name].state_dict().items():
            assert torch.equal(fed.models[name].state_dict()[key], value), f"{name}.{key}"


# ---- remat -----------------------------------------------------------------------------

def test_remat_matches_plain_step_and_jax_remat(shared):
    """One SGD(1.0) step with remat: the same update as the step without it
    (parameters to f32 rounding, running statistics bit for bit, updated
    once: num_batches_tracked 1), and as the JAX package's remat step."""
    config, models, _, _ = shared
    tp = dict(config["train_params"], remat=True)
    rng = np.random.RandomState(0)
    batch = {k: rng.rand(B, 1, HW, HW, 3).astype(np.float32) for k in ("source", "video")}
    trainers = {}
    for remat in (True, False):
        trainer = _port_trainer(shared, dict(tp, remat=remat), 1.0)
        out = trainer.step({k: torch.from_numpy(v) for k, v in batch.items()})
        trainers[remat] = (trainer, out)
    (with_remat, out), (plain, plain_out) = trainers[True], trainers[False]
    assert with_remat.remat and not plain.remat
    torch.testing.assert_close(out["metrics"], plain_out["metrics"], rtol=0, atol=0)
    for name in MODEL_NAMES:
        got, want = with_remat.models[name].state_dict(), plain.models[name].state_dict()
        for key, value in want.items():
            if "running_" in key or key.endswith("num_batches_tracked"):
                assert torch.equal(got[key], value), f"{name}.{key}"
                if key.endswith("num_batches_tracked"):
                    assert int(value) == 1
            else:
                torch.testing.assert_close(got[key], value, rtol=0, atol=1e-6,
                                           msg=f"{name}.{key}")

    sgd = optax.sgd(1.0)
    step = jax.jit(jtrain.make_train_step(models, tp, sgd))
    state, want_out = step(_jax_state(shared, sgd), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["metrics"].numpy(), np.asarray(want_out["metrics"]),
                               rtol=1e-4, atol=1e-5)
    want = _jax_after(state)
    before = {name: m.state_dict() for name, m in port_train_models(config, *shared[2:]).items()}
    moved = 0
    for name in MODEL_NAMES:
        got = with_remat.models[name].state_dict()
        for key, w in want[name].items():
            if key.endswith("num_batches_tracked"):
                continue
            if "running_" in key:
                np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
                continue
            update = (w - before[name][key]).abs().max().item()
            err = (got[key] - w).abs().max().item()
            assert err <= 2e-4 * max(1.0, update), f"{name}.{key}: {err} (update {update})"
            moved += update > 1e-3
    assert moved > 10


# ---- the logger --------------------------------------------------------------------------

def _lines(log_dir):
    with open(os.path.join(log_dir, "log.txt")) as f:
        return [LOG_LINE.match(line).group(1, 2) for line in f.read().strip().splitlines()]


def test_log_chunk_matches_jax_and_per_step_lines(tmp_path):
    """log_chunk over chunks of 5 and 7 steps writes the JAX Logger's lines,
    and the lines log_iter writes step by step; its gifs come from the
    chunk's boundary steps."""
    rng = np.random.RandomState(0)
    values = rng.rand(12, 3).astype(np.float32)
    names = ["a", "b", "c"]
    dirs = {name: tmp_path / name for name in ("port", "jax", "steps")}
    for d in dirs.values():
        d.mkdir()
    asked = []
    with TLogger(str(dirs["port"]), log_freq_iter=3) as logger:
        logger.visualize_rec = lambda inp, out: asked.append((logger.it, inp))
        logger.log_chunk(2, names, torch.from_numpy(values[:5]), 5, vis=lambda j: (j, None))
        logger.log_chunk(7, names, torch.from_numpy(values[5:]), 7, vis=lambda j: (j, None))
        assert logger.it == 13
    with JLogger(str(dirs["jax"]), log_freq_iter=3) as logger:
        logger.log_chunk(2, names, values[:5], 5)
        logger.log_chunk(7, names, values[5:], 7)
    with TLogger(str(dirs["steps"]), log_freq_iter=3) as logger:
        for i, row in enumerate(values):
            logger.log_iter(2 + i, names, torch.from_numpy(row))
    port = _lines(dirs["port"])
    assert [it for it, _ in port] == ["00000003", "00000006", "00000009", "00000012"]
    assert port == _lines(dirs["jax"]) == _lines(dirs["steps"])
    # the boundary iterations' steps: it 3 = chunk 0's step 1, 6 its 4; 9 and 12 chunk 1's 2, 5
    assert asked == [(3, 1), (6, 4), (9, 2), (12, 5)]


@pytest.mark.parametrize("calls", [
    [(0, -1), (4, 0), (9, 4)],
    [(2, -1), (5, 2), (7, 5)],
    [(29, -1), (59, 29)],
    [(0, None), (3, None), (5, None)],
])
def test_log_epoch_prev_epoch_checkpoints_match_jax(tmp_path, calls):
    """log_epoch(epoch, prev_epoch=) writes a checkpoint when any epoch in
    (prev_epoch, epoch] is due, labelled `epoch`, as the JAX Logger does."""
    written = {}
    for name, logger_cls, payload in (
            ("port", TLogger, {"x": torch.zeros(2)}), ("jax", JLogger, {"x": np.zeros(2)})):
        d = tmp_path / name
        d.mkdir()
        with logger_cls(str(d), cpk_freq_epoch=3) as logger:
            for epoch, prev in calls:
                logger.log_epoch(epoch, payload, prev_epoch=prev)
            logger.payload = None  # no exit save: the scheduled ones only
        written[name] = sorted(int(f[:8]) for f in os.listdir(d) if "checkpoint" in f)
    assert written["port"] == written["jax"]
    assert written["port"] == sorted({e for e, p in calls
                                      if any(x % 3 == 0 for x in range(e if p is None else p + 1,
                                                                       e + 1))})


def test_cuts_split_at_due_checkpoints_and_the_profile():
    # 2 steps an epoch, checkpoints every 2 epochs: epochs 0 and 2 end after steps 1 and 5
    assert tloop._cuts([0, 0, 1, 1, 2, 2, 3, 3], 0, 0, 2, 2) == [0, 2, 6, 8]
    # 1 step an epoch (actions): every due epoch ends a dispatch
    assert tloop._cuts(list(range(30)), 0, 0, 1, 5000) == [0, 1, 30]
    assert tloop._cuts(list(range(30, 60)), 30, 0, 1, 5000) == [0, 30]
    # the profiled steps 10..20
    assert tloop._cuts([5] * 12, 4, 0, 100, 10, (10, 20)) == [0, 6, 12]
    assert tloop._cuts([5] * 12, 12, 0, 100, 10, (10, 20)) == [0, 9, 12]


# ---- train() -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory, videos):
    root = tmp_path_factory.mktemp("dispatch_videos")
    for split, n in (("train", N_VIDEOS), ("test", 1)):
        os.makedirs(root / split)
        for i in range(n):
            write_stacked_png(str(root / split / f"{i:03d}.png"),
                              videos[i].astype(np.float32) / 255.0)
    return str(root)


def _loop_config(root, **train_params):
    config = train_config()
    config["dataset_params"] = {
        "root_dir": root, "image_shape": [HW, HW, 3], "cache_videos": True,
        "augmentation_params": {"flip_param": {"time_flip": True, "horizontal_flip": True},
                                "crop_param": {"size": [HW, HW]}},
    }
    config["train_params"].update(num_epochs=2, batch_size=2, **train_params)
    config["train_params"]["log_params"] = {"log_freq_iter": 1, "cpk_freq_epoch": 1}
    config["visualizer_params"] = {"kp_size": 1, "draw_border": True}
    return config


def _first_row(log_dir):
    _, parts = _lines(log_dir)[0]
    return [float(p.split(" - ")[1]) for p in parts.split("; ")]


def test_train_device_feed_matches_jax(shared, dataset_root, tmp_path):
    """train() with device_feed and k = 2 against the JAX package's, from
    one initial checkpoint: the first log line; the port's run took the
    device feed, 2 steps a dispatch, wrote every line, gif and epoch
    checkpoint."""
    config = _loop_config(dataset_root, device_feed=True, steps_per_dispatch=2)
    _, _, params, batch_stats = shared
    init = str(tmp_path / checkpoint_name(0))
    models = port_train_models(config, params, batch_stats)
    save_checkpoint(init, {**{name: m.state_dict() for name, m in models.items()},
                           "epoch": 0, "it": 0})
    dirs = {name: tmp_path / name for name in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        init_models = init_models_once()
        mp.setattr(jbuild, "init_models", init_models)
        mp.setattr(jloop, "init_models", init_models)
        jloop.train(copy.deepcopy(config), str(dirs["jax"]),
                    JFramesDataset(is_train=True, **config["dataset_params"]), checkpoint=init)
    run = tloop.train(config, str(dirs["port"]),
                      TFramesDataset(is_train=True, **config["dataset_params"]),
                      checkpoint=init, device="cpu")
    np.testing.assert_allclose(_first_row(dirs["port"]), _first_row(dirs["jax"]),
                               rtol=1e-3, atol=1e-5)
    assert run.device_feed and run.steps_per_dispatch == 2 and run.cache_bytes > 0
    assert run.steps == 4 and run.epochs == [0, 1]
    assert [it for it, _ in _lines(dirs["port"])] == [f"{i:08d}" for i in range(4)]
    assert sorted(os.listdir(dirs["port"] / "train-vis")) == [f"{i:08d}-rec.gif" for i in range(4)]
    for epoch in range(2):
        assert os.path.exists(dirs["port"] / checkpoint_name(epoch))


def test_train_chunked_equals_step_by_step(dataset_root, tmp_path):
    """On the CPU, k = 4 steps a dispatch trains exactly as 1: the same
    log.txt losses and checkpoints (the epoch-0 one cut out of the chunk at
    its epoch's end), bit for bit."""
    runs = {}
    for k in (4, 1):
        out = tmp_path / f"k{k}"
        out.mkdir()
        config = _loop_config(dataset_root, steps_per_dispatch=k)
        runs[k] = tloop.train(config, str(out), TFramesDataset(is_train=True,
                                                               **config["dataset_params"]),
                              device="cpu")
        assert runs[k].steps_per_dispatch == k and not runs[k].device_feed
    assert _lines(tmp_path / "k4") == _lines(tmp_path / "k1")
    for epoch in range(2):
        got = load_checkpoint(str(tmp_path / "k4" / checkpoint_name(epoch)))
        want = load_checkpoint(str(tmp_path / "k1" / checkpoint_name(epoch)))
        assert got["epoch"] == want["epoch"] == epoch and got["it"] == want["it"]
        for name in MODEL_NAMES:
            for key, value in want[name].items():
                assert torch.equal(got[name][key], value), f"epoch {epoch} {name}.{key}"


def test_train_device_feed_gates(dataset_root, tmp_path, capsys):
    """Over the memory budget the run takes the host feed and says so; a
    pipeline with no exact form on the card is refused."""
    config = _loop_config(dataset_root, device_feed=True, device_feed_hbm_gb=1e-6,
                          steps_per_dispatch=2)
    config["train_params"]["num_epochs"] = 1
    run = tloop.train(config, str(tmp_path), TFramesDataset(is_train=True,
                                                            **config["dataset_params"]),
                      device="cpu")
    assert "device_feed disabled" in capsys.readouterr().out
    assert not run.device_feed and run.steps == 2
    config["dataset_params"]["augmentation_params"]["resize_param"] = {"ratio": [0.5, 0.7]}
    with pytest.raises(ValueError, match="exact on-device formulation"):
        tloop.train(config, str(tmp_path), TFramesDataset(is_train=True,
                                                          **config["dataset_params"]),
                    device="cpu")


def test_checkpoint_keeps_the_eager_optimizer_form(shared):
    """A capturable Adam's state_dict (the card's: step counts as f32 device
    tensors, `capturable` True) goes into a checkpoint in the form an eager
    Adam writes, and comes back capturable: the optimizer state of a
    graphed run loads into an eager Trainer and into the JAX package's
    load_any as before."""
    param = torch.nn.Parameter(torch.ones(3))
    eager = torch.optim.Adam([param], lr=2e-4, betas=(0.5, 0.999))
    param.grad = torch.full((3,), 0.5)
    eager.step()
    want = eager.state_dict()
    captured = copy.deepcopy(want)
    captured["param_groups"][0]["capturable"] = True
    captured["state"][0]["step"] = captured["state"][0]["step"].clone()
    got = ttrain._eager_optimizer_state(captured)
    assert got["param_groups"] == want["param_groups"]
    for key, value in want["state"][0].items():
        assert torch.equal(got["state"][0][key], value)
        assert got["state"][0][key].dtype == value.dtype
    assert ttrain._eager_optimizer_state(want) is want  # an eager state passes as it is
    again = torch.optim.Adam([param], lr=2e-4, betas=(0.5, 0.999))
    again.load_state_dict(got)
    ttrain._make_capturable(again)
    assert again.param_groups[0]["capturable"]
    assert again.state[param]["step"].dtype == torch.float32
