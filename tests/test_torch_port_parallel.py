"""The port's data parallelism held against the JAX package's on the CPU:
sharded loading, SyncBatchNorm and one train step over two gloo ranks,
train(num_devices=2), and frame-sharded eval over a device list.

All at the widths of tests/test_train.py's TINY_CONFIG (16^2 frames, 3
keypoints), inputs from numpy seeds, weights made by the JAX package and
copied into the port (`from_jax_variables`). The ranks are processes
started by `monkeynet_tpu_torch.parallel.distributed.spawn` with a gloo
group, each with a timeout of its own.

Tolerances: the two-rank step against the JAX package's two-device sharded
step at tests/test_distributed.py's limits (parameters 2e-4, batch
statistics 1e-4, metrics 1e-4); the batch norm over two ranks against one
process at the whole batch and against the JAX SyncBatchNorm under
shard_map to 1e-5; frame sharding against the unsharded port and the JAX
package's frame-sharded engines to 1e-5 (tests/test_frame_sharding.py's),
keypoint covariances against JAX to tests/test_torch_port_eval.py's 1e-4;
the loader's shards and plans exactly. train(num_devices=2) against one
process at the same global batch to tests/test_torch_port_loop.py's limits.
"""

from __future__ import annotations

import copy
import functools
import inspect
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import monkeynet_tpu_torch.tasks.train_loop as tloop
from monkeynet_tpu.data.dataset import FramesDataset as JFramesDataset
from monkeynet_tpu.data import device_feed as jfeed
from monkeynet_tpu.data.loader import DataLoader as JDataLoader
from monkeynet_tpu.models import blocks as jblocks
from monkeynet_tpu.parallel.mesh import make_frame_sharded_animator, make_mesh
from monkeynet_tpu.parallel.mesh import make_sharded_train_step as jax_make_sharded_step
from monkeynet_tpu.tasks import animate as janimate
from monkeynet_tpu.tasks import train as jtrain
from monkeynet_tpu.tasks import build as jbuild
from monkeynet_tpu.tasks.build import init_models
from monkeynet_tpu_torch.data import device_feed as tfeed
from monkeynet_tpu_torch.data.dataset import FramesDataset as TFramesDataset
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.data.loader import DataLoader as TDataLoader
from monkeynet_tpu_torch.models.blocks import SyncBatchNorm
from monkeynet_tpu_torch.parallel import make_devices, shard_batch
from monkeynet_tpu_torch.parallel import distributed
from monkeynet_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    shard_host_local_batch,
    spawn,
)
from monkeynet_tpu_torch.parallel.mesh import local_devices, make_frame_sharded_animator as \
    port_frame_sharded_animator
from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor, TransferEngine
from monkeynet_tpu_torch.tasks.train import MODEL_NAMES
from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import (
    _randomize_batch_stats,
    port_models,
    port_train_models,
    random_kp,
    train_config,
)
from .torch_port_parallel_workers import batchnorm_and_step_rank, sleep_rank

HW = 16
GLOBAL_BATCH = 8
RANK_TIMEOUT_S = 180
KP_ATOL = {"mean": 1e-5, "var": 1e-4}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _step_batch():
    """tests/test_train.py's `_batch()`: the global batch of 8."""
    rng = np.random.RandomState(0)
    return {"source": rng.rand(GLOBAL_BATCH, 1, HW, HW, 3).astype(np.float32),
            "video": rng.rand(GLOBAL_BATCH, 1, HW, HW, 3).astype(np.float32)}


def _bn_case():
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 2, 3, 3, 6) * 2.0 + 0.5).astype(np.float32)
    dout = rng.randn(*x.shape).astype(np.float32)
    stats = {"mean": (rng.randn(6) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32),
             "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
             "bias": rng.randn(6).astype(np.float32)}
    return x, dout, stats


# ---- two gloo ranks: the batch norm and one train step ----------------------------

@functools.lru_cache(maxsize=None)
def _jax_init():
    """(models, params, batch_stats) of the JAX package's init at
    PRNGKey(0), made once for the module (it takes ~10 s)."""
    models, params, batch_stats = init_models(train_config(), jax.random.PRNGKey(0),
                                              (HW, HW, 3))
    return models, _np_tree(params), _np_tree(batch_stats)


@pytest.fixture(scope="module")
def shared():
    """The config and the JAX package's initial weights, as
    tests/test_distributed.py steps them (the randomised statistics of
    `jax_variables` make this step ill-conditioned: there the JAX package's
    own one- and two-device steps differ by 1.7e-3)."""
    config = train_config()
    config["train_params"]["batch_size"] = GLOBAL_BATCH
    _, params, batch_stats = _jax_init()
    return config, params, batch_stats


@pytest.fixture(scope="module")
def two_ranks(shared):
    """Both ranks' batch norm and train step, in one spawn of two gloo
    processes."""
    config, params, batch_stats = shared
    models = port_train_models(config, params, batch_stats)
    state_dicts = {name: models[name].state_dict() for name in MODEL_NAMES}
    return spawn(batchnorm_and_step_rank, ["cpu", "cpu"], "gloo",
                 args=(_bn_case(), config, state_dicts, _step_batch()), timeout=RANK_TIMEOUT_S)


def _jax_bn_sharded(x, dout, stats):
    """The JAX SyncBatchNorm over the 'data' axis of a 2-device mesh: y,
    dx, the affine gradients and the updated running statistics."""
    bn = jblocks.SyncBatchNorm(x.shape[-1], axis_name="data")
    params = {"scale": jnp.asarray(stats["scale"]), "bias": jnp.asarray(stats["bias"])}
    running = {"mean": jnp.asarray(stats["mean"]), "var": jnp.asarray(stats["var"])}

    def body(params, running, x, dout):
        def loss(params, x):
            y, mut = bn.apply({"params": params, "batch_stats": running}, x, True,
                              mutable=["batch_stats"])
            return jnp.sum(y * dout), (y, mut["batch_stats"])

        (_, (y, new_running)), (dparams, dx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, dx, dparams, new_running

    fn = jax.shard_map(body, mesh=make_mesh(2), in_specs=(P(), P(), P("data"), P("data")),
                       out_specs=(P("data"), P("data"), P(), P()))
    return _np_tree(jax.jit(fn)(params, running, jnp.asarray(x), jnp.asarray(dout)))


def _port_bn_whole(x, dout, stats):
    bn = SyncBatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        bn.weight.copy_(torch.from_numpy(stats["scale"]))
        bn.bias.copy_(torch.from_numpy(stats["bias"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(dout)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            **bn.state_dict()}


def _ranks_cat(results, key):
    return torch.cat([r["bn"][key] for r in results]).numpy()


def test_batchnorm_over_two_ranks_matches_one_process(two_ranks):
    """The statistics of the global batch: the ranks' outputs and input
    gradients together, the summed affine gradients and the running
    statistics (unbiased with the global count) are one process's at the
    whole batch."""
    want = _port_bn_whole(*_bn_case())
    for key in ("y", "dx"):
        np.testing.assert_allclose(_ranks_cat(two_ranks, key), want[key].numpy(), atol=1e-5)
    for key in ("dweight", "dbias"):
        got = sum(r["bn"][key] for r in two_ranks)
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), atol=1e-5)
    for r in two_ranks:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(r["bn"][key].numpy(), want[key].numpy(), atol=1e-5)
        assert int(r["bn"]["num_batches_tracked"]) == 1
    # a per-rank statistic would give each rank's slab mean zero and unit
    # variance; the global one does not
    slab = two_ranks[0]["bn"]["y"].numpy()
    assert np.abs(slab.reshape(-1, 6).mean(0) - _bn_case()[2]["bias"]).max() > 1e-2


def test_batchnorm_over_two_ranks_matches_jax_shard_map(two_ranks):
    x, dout, stats = _bn_case()
    y, dx, dparams, running = _jax_bn_sharded(x, dout, stats)
    np.testing.assert_allclose(_ranks_cat(two_ranks, "y"), y, atol=1e-5)
    np.testing.assert_allclose(_ranks_cat(two_ranks, "dx"), dx, atol=1e-5)
    np.testing.assert_allclose(sum(r["bn"]["dweight"] for r in two_ranks).numpy(),
                               dparams["scale"], atol=1e-5)
    np.testing.assert_allclose(sum(r["bn"]["dbias"] for r in two_ranks).numpy(),
                               dparams["bias"], atol=1e-5)
    for r in two_ranks:
        np.testing.assert_allclose(r["bn"]["running_mean"].numpy(), running["mean"], atol=1e-5)
        np.testing.assert_allclose(r["bn"]["running_var"].numpy(), running["var"], atol=1e-5)


@pytest.fixture(scope="module")
def jax_sharded_step(shared):
    config, params, batch_stats = shared
    models = dict(zip(("generator", "discriminator", "kp_detector"),
                      jbuild.build_models(config, axis_name="data")))
    optimizer = optax.sgd(1.0)
    state = jtrain.create_train_state(jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, batch_stats), optimizer)
    step = jax_make_sharded_step(models, config["train_params"], optimizer, num_devices=2)
    new_state, out = step(state, {k: jnp.asarray(v) for k, v in _step_batch().items()})
    after = {name: from_jax_variables(_np_tree(new_state.params[name]),
                                      _np_tree(new_state.batch_stats.get(name, {})))
             for name in MODEL_NAMES}
    return after, np.asarray(out["metrics"])


def test_two_rank_step_matches_jax_sharded_step(two_ranks, jax_sharded_step):
    """One SGD(1.0) step on two gloo ranks against the JAX package's
    make_sharded_train_step(num_devices=2) on the same global batch and
    weights: parameters to 2e-4, batch statistics to 1e-4, metrics to 1e-4."""
    want, want_metrics = jax_sharded_step
    got = two_ranks[0]
    np.testing.assert_allclose(got["metrics"].numpy(), want_metrics, atol=1e-4)
    moved = 0
    for name in MODEL_NAMES:
        assert set(got["state"][name]) == set(want[name])
        for key, w in want[name].items():
            g = got["state"][name][key]
            if key.endswith("num_batches_tracked"):
                assert int(g) == 1
                continue
            atol = 1e-4 if "running_" in key else 2e-4
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, err_msg=f"{name}.{key}")
            moved += 1
    assert moved > 50


def test_two_rank_step_leaves_the_ranks_equal(two_ranks):
    """Both ranks hold the same parameters and statistics after the step,
    bit for bit, and the same global metrics. Each rank issued one
    all-reduce a batch norm in the forward and one in the backward, one for
    the metrics and one for each network's gradients."""
    a, b = two_ranks
    for name in MODEL_NAMES:
        for key, value in a["state"][name].items():
            assert torch.equal(value, b["state"][name][key]), f"{name}.{key}"
    assert torch.equal(a["metrics"], b["metrics"])
    assert a["collectives"] == b["collectives"] == 2 * a["norms"] + 1 + len(MODEL_NAMES)


def test_two_rank_remat_step_matches_the_plain_one(two_ranks):
    """With remat the recompute runs the batch norms' all-reduces again, on
    every rank alike (no deadlock), leaves their running statistics alone
    (one update a step), and the step equals the plain two-rank step."""
    for r in two_ranks:
        assert r["remat"]["collectives"] > r["collectives"]
        for name in MODEL_NAMES:
            for key, want in r["state"][name].items():
                got = r["remat"]["state"][name][key]
                if key.endswith("num_batches_tracked"):
                    assert int(got) == int(want) == 1
                else:
                    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                               err_msg=f"{name}.{key}")
        np.testing.assert_allclose(r["remat"]["metrics"].numpy(), r["metrics"].numpy(),
                                   atol=1e-6)


def test_a_gloo_group_refuses_the_cuda_graph(two_ranks):
    assert all(r["graph_refused"] for r in two_ranks)


# ---- sharded loading --------------------------------------------------------------

FLIPS = {"time_flip": True, "horizontal_flip": True}
N_VIDEOS, T = 10, 6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_videos")
    rng = np.random.default_rng(3)
    for split, n in (("train", N_VIDEOS), ("test", 2)):
        os.makedirs(root / split)
        for i in range(n):
            video = (rng.random((T - i % 3, HW, HW, 3)) * 255).astype(np.uint8)
            write_stacked_png(str(root / split / f"v{i:02d}.png"), video / np.float32(255.0))
    return str(root)


def _dataset_params(root):
    return dict(root_dir=root, image_shape=(HW, HW, 3), cache_videos=True,
                augmentation_params={"flip_param": FLIPS, "crop_param": {"size": (HW, HW)},
                                     "jitter_param": {"hue": 0.5, "brightness": 0.3}})


def _loader_batches(loader_cls, dataset, **kw):
    loader = loader_cls(dataset, num_workers=1, seed=4, **kw)
    return len(loader), list(loader.stream(2))


def test_loader_shards_match_jax_and_make_the_global_batch(root):
    """DataLoader(num_shards=2, shard_index=i) puts out the JAX loader's
    slabs (indices and augmented pixels, exactly), each shard counts global
    batches, and the two shards together are the unsharded global batch:
    the item generators are keyed by the global position."""
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    jds = JFramesDataset(is_train=True, **_dataset_params(root))
    n_global, whole = _loader_batches(TDataLoader, tds, batch_size=4)
    shards = []
    for i in range(2):
        n, got = _loader_batches(TDataLoader, tds, batch_size=2, num_shards=2, shard_index=i)
        n_jax, want = _loader_batches(JDataLoader, jds, batch_size=2, num_shards=2,
                                      shard_index=i)
        assert n == n_jax == n_global == N_VIDEOS // 4
        assert [ep for ep, _ in got] == [ep for ep, _ in want] == [0, 0, 1, 1]
        for (_, g), (_, w) in zip(got, want):
            assert set(g) == set(w)
            for key in ("source", "video"):
                np.testing.assert_array_equal(g[key], w[key])
            assert g["name"] == w["name"]
        shards.append(got)
    for j, (ep, batch) in enumerate(whole):
        for key in ("source", "video"):
            np.testing.assert_array_equal(
                np.concatenate([shards[0][j][1][key], shards[1][j][1][key]]), batch[key])
        assert shards[0][j][1]["name"] + shards[1][j][1]["name"] == batch["name"]


def test_sharded_loader_requires_drop_last(root):
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    with pytest.raises(ValueError, match="drop_last"):
        TDataLoader(tds, batch_size=2, drop_last=False, num_shards=2)


def test_plan_stream_shards_match_jax_and_make_the_global_batch(root):
    """plan_stream(num_shards=2, shard_index=i) against the JAX package's,
    plan for plan; the two shards' plans together are the unsharded
    stream's."""
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    jds = JFramesDataset(is_train=True, **_dataset_params(root))
    lengths = np.asarray([T - i % 3 for i in range(N_VIDEOS)], np.int32)
    whole = list(tfeed.plan_stream(tds, tds.transform, lengths, 4, 4, 1, 2))
    shards = []
    for i in range(2):
        got = list(tfeed.plan_stream(tds, tds.transform, lengths, 2, 4, 1, 2,
                                     num_shards=2, shard_index=i))
        want = list(jfeed.plan_stream(jds, jds.transform, lengths, 2, 4, 1, 2,
                                      num_shards=2, shard_index=i))
        assert [ep for ep, _ in got] == [ep for ep, _ in want] == [1, 1, 2, 2]
        for (_, g), (_, w) in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
        shards.append(got)
    for j, (_, plan) in enumerate(whole):
        for key in plan:
            np.testing.assert_array_equal(
                np.concatenate([shards[0][j][1][key], shards[1][j][1][key]]), plan[key])


def test_shard_helpers_split_a_batch_into_slabs():
    batch = {"x": np.arange(24, dtype=np.float32).reshape(6, 4)}
    slabs = shard_batch(batch, ["cpu", "cpu", "cpu"])
    assert [s["x"].shape for s in slabs] == [(2, 4)] * 3
    np.testing.assert_array_equal(torch.cat([s["x"] for s in slabs]).numpy(), batch["x"])
    np.testing.assert_array_equal(shard_host_local_batch(batch, "cpu")["x"].numpy(), batch["x"])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, ["cpu"] * 4)


# ---- train(num_devices=2) ---------------------------------------------------------

LOOP_EPOCHS, LOOP_STEPS_PER_EPOCH = 2, 2


def _loop_config(root):
    config = train_config()
    config["dataset_params"] = {
        "root_dir": root, "image_shape": [HW, HW, 3],
        "augmentation_params": {"flip_param": FLIPS, "crop_param": {"size": [HW, HW]}},
    }
    config["train_params"].update(num_epochs=LOOP_EPOCHS, epoch_milestones=[1], batch_size=4,
                                  num_workers=1)
    config["train_params"]["log_params"] = {"log_freq_iter": 1, "cpk_freq_epoch": 1}
    config["visualizer_params"] = {"kp_size": 1, "draw_border": True}
    return config


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """train() on two gloo ranks and in one process, at global batch 4 over
    8 videos (2 epochs of 2 steps), and a resume of the two-rank run's
    epoch-0 checkpoint into one process."""
    root = tmp_path_factory.mktemp("loop_videos")
    rng = np.random.RandomState(0)
    for split, n in (("train", 4 * LOOP_STEPS_PER_EPOCH), ("test", 1)):
        os.makedirs(root / split)
        for i in range(n):
            write_stacked_png(str(root / split / f"{i:03d}.png"),
                              rng.rand(5, HW, HW, 3).astype(np.float32))
    config = _loop_config(str(root))
    dataset = TFramesDataset(is_train=True, **config["dataset_params"])
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in ("two", "one", "resumed")}
    out = {"config": config, "dirs": dirs}
    asked = []

    def bounded_spawn(*args, **kwargs):
        """spawn() with the deadline train() asked for recorded, and this
        test's own deadline in its place."""
        call = inspect.signature(spawn).bind(*args, **kwargs)
        call.apply_defaults()
        asked.append(call.arguments["timeout"])
        call.arguments["timeout"] = RANK_TIMEOUT_S
        return spawn(*call.args, **call.kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(tloop, "spawn", bounded_spawn)
        out["two"] = tloop.train(config, dirs["two"], dataset, num_devices=2, device="cpu")
    out["spawn_timeouts"] = asked
    out["one"] = tloop.train(config, dirs["one"], dataset, device="cpu")
    out["resumed"] = tloop.train(config, dirs["resumed"], dataset, device="cpu",
                                 checkpoint=os.path.join(dirs["two"], checkpoint_name(0)))
    return out


def test_two_rank_train_writes_from_rank_zero_only(loop_runs):
    """The spawning call returns rank 0's run (no trainer); log.txt, one
    gif a logged step and one checkpoint an epoch, written once."""
    run, log_dir = loop_runs["two"], loop_runs["dirs"]["two"]
    assert run.trainer is None and run.steps == LOOP_EPOCHS * LOOP_STEPS_PER_EPOCH
    assert run.epochs == list(range(LOOP_EPOCHS))
    assert sorted(os.listdir(log_dir)) == sorted(
        ["log.txt", "train-vis"] + [checkpoint_name(e) for e in range(LOOP_EPOCHS)])
    rows = open(os.path.join(log_dir, "log.txt")).read().splitlines()
    assert [int(r.split(")")[0]) for r in rows] == list(range(run.steps))
    gifs = sorted(os.listdir(os.path.join(log_dir, "train-vis")))
    assert gifs == [f"{it:08d}-rec.gif" for it in range(run.steps)]


def test_two_rank_train_spawns_with_no_deadline(loop_runs):
    """A training run may take hours: train() spawns its ranks with no
    timeout (spawn still stops them when one fails or dies)."""
    assert loop_runs["spawn_timeouts"] == [None]


@pytest.mark.parametrize("timeout", [None, 7200.0])
def test_spawn_deadline_only_when_asked(monkeypatch, timeout):
    """Under a clock that runs an hour a reading, spawn() without a timeout
    waits for a rank that answers after 2 s (hours on that clock), and with
    a two-hour timeout stops it and raises."""
    hours = iter(range(10**6))
    monkeypatch.setattr(distributed, "time",
                        types.SimpleNamespace(monotonic=lambda: 3600.0 * next(hours)))
    if timeout is None:
        assert spawn(sleep_rank, ["cpu"], "gloo", args=(2.0,)) == [0]
    else:
        with pytest.raises(TimeoutError, match="within 7200.0 s"):
            spawn(sleep_rank, ["cpu"], "gloo", args=(2.0,), timeout=timeout)


def test_two_rank_train_matches_one_process(loop_runs):
    """The two-rank run's last checkpoint against one process at the same
    global batch, at tests/test_torch_port_loop.py's limits: Adam parameters
    and statistics within 2 * lr * steps (+1e-6), at least 98% of the
    parameter entries within 1e-6; the logged losses to 1e-4 relative."""
    steps = LOOP_EPOCHS * LOOP_STEPS_PER_EPOCH
    lr = loop_runs["config"]["train_params"]["lr"]
    got = load_checkpoint(os.path.join(loop_runs["dirs"]["two"],
                                       checkpoint_name(LOOP_EPOCHS - 1)))
    want = load_checkpoint(os.path.join(loop_runs["dirs"]["one"],
                                        checkpoint_name(LOOP_EPOCHS - 1)))
    close = total = 0
    for name in MODEL_NAMES:
        for key, w in want[name].items():
            g = got[name][key]
            if key.endswith("num_batches_tracked"):
                assert int(g) == int(w) == steps
                continue
            err = (g - w).abs()
            assert err.max().item() <= 2 * lr * steps + 1e-6, f"{name}.{key}"
            close += int((err <= 1e-6).sum())
            total += err.numel()
    assert close >= 0.98 * total
    for a, b in zip(*(open(os.path.join(loop_runs["dirs"][k], "log.txt")).read().splitlines()
                      for k in ("two", "one"))):
        va = [float(p.split(" - ")[1]) for p in a.split(") ")[1].split("; ")[:-1]]
        vb = [float(p.split(" - ")[1]) for p in b.split(") ")[1].split("; ")[:-1]]
        np.testing.assert_allclose(va, vb, rtol=1e-4, atol=1e-5)


def test_two_rank_checkpoint_resumes_into_one_process(loop_runs):
    """A checkpoint of the two-rank run resumes into one process: it trains
    epoch 0 again and counts on from the checkpoint's iteration."""
    resumed = loop_runs["resumed"]
    assert resumed.epochs == list(range(LOOP_EPOCHS)) and resumed.trainer is not None
    saved = load_checkpoint(os.path.join(loop_runs["dirs"]["two"], checkpoint_name(0)))
    rows = open(os.path.join(loop_runs["dirs"]["resumed"], "log.txt")).read().splitlines()
    assert int(rows[0].split(")")[0]) == saved["it"]


def test_train_checks_the_batch_against_the_devices(loop_runs, monkeypatch):
    config = copy.deepcopy(loop_runs["config"])
    dataset = TFramesDataset(is_train=True, **config["dataset_params"])
    with pytest.raises(ValueError, match="batch_size 4 must be divisible by num_devices 3"):
        tloop.train(config, loop_runs["dirs"]["one"], dataset, num_devices=3, device="cpu")


# ---- frame-sharded eval -----------------------------------------------------------

@pytest.fixture(scope="module")
def eval_models():
    """The JAX package's initial weights with `jax_variables`' changes:
    random running statistics and a non-zero dense-motion head."""
    config = train_config()
    models, params, batch_stats = _jax_init()
    params = copy.deepcopy(params)
    rng = np.random.RandomState(0)
    batch_stats = {k: _randomize_batch_stats(v, rng) for k, v in batch_stats.items()}
    head = params["generator"]["dense_motion"]["hourglass"]["decoder"]["final_conv"]["conv"]
    head["kernel"] = (rng.randn(*head["kernel"].shape) * 0.02).astype(np.float32)
    jvars = {name: {"params": params[name], "batch_stats": batch_stats[name]}
             for name in ("generator", "kp_detector")}
    return config, models, jvars, params, batch_stats


def _eval_inputs(D):
    rng = np.random.RandomState(D)
    kp_d = random_kp(rng, 1, D, 3)
    return {"source": rng.rand(1, 1, HW, HW, 3).astype(np.float32),
            "driving": rng.rand(1, D, HW, HW, 3).astype(np.float32),
            "kp_driving": kp_d, "kp_source": {k: v[:, :1] for k, v in kp_d.items()}}


_JAX_REFS = {}


def _jax_ref(kind, D, eval_models):
    """The JAX package's engine of `kind` over a 2-device mesh, once per D."""
    if (kind, D) not in _JAX_REFS:
        _, models, jvars, _, _ = eval_models
        x, mesh = _eval_inputs(D), make_mesh(2)
        if kind == "animator":
            fn = make_frame_sharded_animator(models["generator"], jvars["generator"], mesh)
            out = fn(x["source"], x["kp_driving"], x["kp_source"])
        elif kind == "transfer":
            engine = janimate.TransferEngine(models["generator"], models["kp_detector"],
                                             jvars["generator"], jvars["kp_detector"], mesh=mesh)
            out = engine(x["source"], x["driving"])
        else:
            out = janimate.KPExtractor(models["kp_detector"], jvars["kp_detector"],
                                       mesh=mesh)(x["driving"])
        _JAX_REFS[(kind, D)] = _np_tree(out)
    return _JAX_REFS[(kind, D)]


def _port_engine(kind, devices, eval_models):
    config, _, _, params, batch_stats = eval_models
    generator, kp_detector = port_models(config, params, batch_stats)
    if kind == "animator":
        return port_frame_sharded_animator(generator, devices)
    if kind == "transfer":
        return TransferEngine(generator, kp_detector, devices=devices)
    return KPExtractor(kp_detector, devices=devices)


def _port_out(kind, engine, x):
    if kind == "animator":
        out = engine(x["source"], x["kp_driving"], x["kp_source"])
    elif kind == "transfer":
        out = engine(x["source"], x["driving"])
    else:
        out = engine.device_call(x["driving"])
    return jax.tree.map(lambda t: t.numpy(), out)


def _assert_close(got, want, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], atol, f"{path}.{k}")
        return
    tol = KP_ATOL["var"] if atol == "kp" and path.endswith("var") else \
        (1e-5 if atol == "kp" else atol)
    assert got.shape == want.shape, path
    np.testing.assert_allclose(got, want, atol=tol, err_msg=path)


@pytest.mark.parametrize("kind", ["animator", "transfer", "kp_extractor"])
@pytest.mark.parametrize("N,D", [(2, 16), (2, 5), (3, 16), (3, 5)])
def test_frame_sharded_engines_match_unsharded_and_jax(eval_models, kind, N, D):
    """`devices=['cpu'] * N`: the chunk padded to lcm(16, N) frames (16 or
    48), one slab a device, gathered and trimmed; the outputs equal the
    unsharded port's and the JAX package's frame-sharded engine's (2-device
    mesh)."""
    x = _eval_inputs(D)
    engine = _port_engine(kind, ["cpu"] * N, eval_models)
    assert engine.granularity == int(np.lcm(16, N)) and len(engine.devices) == N
    got = _port_out(kind, engine, x)
    unsharded = _port_out(kind, _port_engine(kind, ["cpu"], eval_models), x)
    _assert_close(got, unsharded, 1e-5)
    want = _jax_ref(kind, D, eval_models)
    _assert_close(got, want, "kp")
    lead = got["mean"] if kind == "kp_extractor" else got["video_prediction"]
    assert lead.shape[1] == D


def test_replicas_are_made_once_per_device(eval_models):
    config, _, _, params, batch_stats = eval_models
    generator, kp_detector = port_models(config, params, batch_stats)
    engine = TransferEngine(generator, kp_detector, devices=["cpu", "cpu"])
    assert engine.generators[0] is engine.generators[1] is generator
    assert Animator(generator, devices=["cpu", "cpu", "cpu"]).granularity == 48


# ---- the group, the devices and the CLI --------------------------------------------

def test_maybe_initialize_distributed_needs_the_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_make_devices_refuses_more_devices_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_devices(1) == [torch.device("cuda:0")]
    with pytest.raises(ValueError, match="requested 2 devices but only 1"):
        make_devices(2)
    with pytest.raises(ValueError, match="requested 3 devices but only 2"):
        make_devices(3, ["cpu", "cpu"])
    assert make_devices(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    assert local_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert local_devices(1, "cuda:0") == [torch.device("cuda:0")]


def test_cli_passes_num_devices_on(loop_runs, tmp_path, monkeypatch):
    """`--num_devices N` reaches train() and the three eval drivers."""
    import yaml

    from monkeynet_tpu_torch import run
    from monkeynet_tpu_torch.tasks import prediction, reconstruction, transfer
    from monkeynet_tpu_torch.utils import device as device_mod

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(loop_runs["config"]))
    monkeypatch.setattr(device_mod, "require_device", lambda device: torch.device("cpu"))
    seen = {}

    def record(mode):
        def fn(*args, num_devices=1, **kwargs):
            seen[mode] = num_devices
            return tloop.TrainRun(None, [], 0, 1.0, 0.0) if mode == "train" else \
                {"losses": [0.0], "videos": 0}
        return fn

    monkeypatch.setattr(tloop, "train", record("train"))
    monkeypatch.setattr(reconstruction, "reconstruction", record("reconstruction"))
    monkeypatch.setattr(transfer, "transfer", record("transfer"))
    monkeypatch.setattr(prediction, "prediction", record("prediction"))
    for mode in ("train", "reconstruction", "transfer", "prediction"):
        argv = ["--config", str(path), "--log_dir", str(tmp_path / "log"), "--mode", mode,
                "--num_devices", "2"]
        if mode != "train":
            argv += ["--checkpoint", str(tmp_path / "none.pth.tar")]
        assert run.main(argv) == 0
    assert seen == dict.fromkeys(("train", "reconstruction", "transfer", "prediction"), 2)
