"""The port reads the JAX package's msgpack checkpoints: its decoder
(monkeynet_tpu_torch/utils/msgpack.py) against msgpack and flax, and the
train state it gives (utils/checkpoint.py `load_any`) against the JAX
package's own, on the CPU.

- The decoder: every msgpack type and width flax can write, flax's ext
  types 1-3 and its chunked arrays, on seeded trees, equal to
  `flax.serialization.msgpack_restore` leaf for leaf (bf16 bit for bit).
- tests/fixtures/jax_train_checkpoint.msgpack, written by the JAX package's
  train() (scripts/make_jax_checkpoint_fixture.py): it decodes identically
  through flax and the port.
- configs/shapes.yaml at full width, state only: the JAX package's
  create_train_state, Adam moments at count 1234 and its checkpoint
  payload, restored into the port's Trainer bit for bit, at the JAX
  schedule's rate.
- At the fixture's tiny widths: the evaluation networks of both packages'
  `load_eval_models` through both engines, to the model tests' limits
  (keypoint means 1e-5, variances 1e-4, frames 1e-4); one resumed Adam step
  in both packages, to the loop test's limits (a parameter within 2 * lr of
  the JAX step, 98% of the entries within 1e-6); reconstruction() and the
  CLI's four modes from the file.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

import chip_smoke
import monkeynet_tpu.tasks.build as jbuild
import monkeynet_tpu.tasks.reconstruction as jrecon
import monkeynet_tpu.tasks.train as jtrain
import monkeynet_tpu.tasks.train_loop as jloop
from monkeynet_tpu.tasks import animate as janimate
from monkeynet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from monkeynet_tpu_torch.tasks import animate as tanimate
from monkeynet_tpu_torch.tasks import reconstruction as trecon
from monkeynet_tpu_torch.tasks.build import build_train_models
from monkeynet_tpu_torch.tasks.train import MODEL_NAMES, Trainer
from monkeynet_tpu_torch.utils.checkpoint import (from_jax_checkpoint, load_any,
                                                  save_checkpoint)
from monkeynet_tpu_torch.utils.msgpack import msgpack_restore, read_msgpack
from monkeynet_tpu_torch.utils.weights import adam_state_dict, from_jax_variables

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_train_checkpoint.msgpack"
FIXTURE_CONFIG = REPO / "tests" / "fixtures" / "jax_train_checkpoint.yaml"
FIXTURE_STEPS_PER_EPOCH = 2  # 8 videos at batch 4
KP_ATOL = {"mean": 1e-5, "var": 1e-4}
OUT_ATOL = 1e-4


def _fixture_config(root_dir=None):
    config = yaml.safe_load(FIXTURE_CONFIG.read_text())
    config["dataset_params"]["root_dir"] = str(root_dir or REPO / "data" / "shapes")
    return config


def _assert_same_tree(got, want, where=""):
    """The port's decoded tree equals flax's: the same containers and keys,
    Python values equal with their types, numpy arrays of one dtype and
    shape with equal bytes, writable; a bf16 array (a torch tensor in the
    port) bit for bit. Returns the number of leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        return sum(_assert_same_tree(got[k], want[k], f"{where}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        return sum(_assert_same_tree(g, w, f"{where}[{i}]") for i, (g, w) in
                   enumerate(zip(got, want)))
    if isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == want.shape, where
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), where
        return 1
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
        assert got.flags.writeable, where
    elif isinstance(want, (float, np.floating)) and want != want:
        assert got != got, where  # NaN
    else:
        assert got == want, where
    return 1


# ---- the decoder ----------------------------------------------------------------

_PLAIN = {
    "nil_and_bool": [None, True, False],
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, -0.0, 1.5, -2.25e-300, 3.4e38, float("inf"), float("-inf"),
               float("nan")],
    "strings": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 255, "d" * 256,
                "e" * 65535, "f" * 65536],
    "bins": [b"", b"x" * 31, b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
    "arrays": [[], list(range(15)), list(range(16)), list(range(65536)),
               [[1, [2, [3]]], []]],
    "maps": [{}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {str(i): i for i in range(65536)}, {"a": {"b": {"c": None}}}],
}


@pytest.mark.parametrize("case", sorted(_PLAIN))
@pytest.mark.parametrize("single_float", [False, True])
def test_decoder_reads_every_plain_type(case, single_float):
    """nil, bool, every int width, float32 and float64, str8/16/32,
    bin8/16/32, fixarray/array16/array32 and fixmap/map16/map32, as the
    msgpack package and flax read them."""
    value = _PLAIN[case]
    data = msgpack.packb(value, use_bin_type=True, use_single_float=single_float)
    want = msgpack.unpackb(data, raw=False, strict_map_key=False)
    if case != "floats" or not single_float:
        _assert_same_tree(serialization.msgpack_restore(data), want)
    _assert_same_tree(msgpack_restore(data), want)


def _seeded_arrays(seed):
    rng = np.random.RandomState(seed)
    out = {}
    for dtype in ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                  "uint64", "float16", "float32", "float64", "complex64", "complex128"):
        shape = tuple(rng.randint(1, 5, size=rng.randint(0, 4)))
        raw = rng.randint(0, 256, size=int(np.prod(shape, dtype=np.int64)) *
                          np.dtype(dtype).itemsize).astype(np.uint8)
        arr = raw.view(dtype).reshape(shape)
        if dtype == "bool":
            arr = raw.astype(bool).reshape(shape)
        out[dtype] = arr
    out["bfloat16"] = jnp.asarray(rng.randn(3, 5), jnp.bfloat16)
    out["empty"] = np.zeros((0, 3), np.float32)
    out["empty_bf16"] = jnp.zeros((2, 0), jnp.bfloat16)
    out["scalar_0d"] = np.asarray(7, np.int32)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decoder_matches_flax_on_seeded_trees(seed):
    """Ext 1 (ndarrays of every dtype, 0-d and empty ones, bf16), ext 2
    (Python complex) and ext 3 (numpy scalars) inside nested dicts and
    lists, as flax.serialization.msgpack_serialize writes them."""
    rng = np.random.RandomState(seed)
    tree = {
        "arrays": _seeded_arrays(seed),
        "scalars": {"f32": np.float32(rng.randn()), "i64": np.int64(rng.randint(-9, 9)),
                    "u8": np.uint8(rng.randint(0, 255)), "b": np.bool_(True),
                    "c64": np.complex64(1 + 2j), "bf16": jnp.bfloat16(rng.randn())},
        "python": {"complex": complex(rng.randn(), rng.randn()), "int": int(rng.randint(9)),
                   "float": float(rng.randn()), "str": "x" * int(rng.randint(40)),
                   "none": None, "list": [np.arange(3, dtype=np.int16), 1, "two"]},
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    assert _assert_same_tree(msgpack_restore(data), want) > 20


def test_decoder_joins_chunked_arrays(monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into a
    '__msgpack_chunked_array__' dict (made small here); the port joins the
    chunks back, at the top level and inside dicts."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(3)
    tree = {"big": rng.randn(7, 9).astype(np.float32), "small": np.arange(4, dtype=np.int8),
            "nested": {"big": rng.randint(0, 9, (100,)).astype(np.int64)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_restore(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    for want, have in ((tree["big"], got["big"]), (tree["nested"]["big"], got["nested"]["big"])):
        assert np.array_equal(have, want) and have.dtype == want.dtype
    top = serialization.msgpack_serialize(rng.randn(40).astype(np.float32))
    _assert_same_tree(msgpack_restore(top), serialization.msgpack_restore(top))


def test_decoder_names_the_byte_of_an_unknown_code():
    with pytest.raises(ValueError, match="unknown type code 0xc1 at byte 2"):
        msgpack_restore(b"\x92\x01\xc1")
    ext = msgpack.packb({"a": msgpack.ExtType(9, b"abc")})
    with pytest.raises(ValueError, match=f"unknown ext code 9 at byte {ext.index(b'\xc7')}"):
        msgpack_restore(ext)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(msgpack.packb("abcdef")[:-2])


# ---- the committed fixture --------------------------------------------------------

def test_fixture_decodes_identically_through_flax_and_the_port():
    """The committed file is a JAX package file: flax reads it, and the port
    reads every leaf the same."""
    assert FIXTURE.stat().st_size <= 3 * 2**20
    data = FIXTURE.read_bytes()
    want = serialization.msgpack_restore(data)
    assert _assert_same_tree(read_msgpack(str(FIXTURE)), want) > 300


def test_fixture_holds_the_jax_train_state():
    """What the decoder's callers rely on: optax's chain as {'0': {'count',
    'mu', 'nu'}, '1': {'count'}} with 0-d int32 counts; 'epoch' and 'it' 0-d
    int64 arrays (the JAX save_checkpoint makes every leaf an array); no
    batch statistics for the discriminator."""
    tree = read_msgpack(str(FIXTURE))
    state = tree["state"]
    assert set(tree) == {"state", "epoch", "it"} and set(state) == {
        "step", "params", "batch_stats", "opt_states"}
    assert sorted(state["batch_stats"]) == ["generator", "kp_detector"]
    for name in MODEL_NAMES:
        chain = state["opt_states"][name]
        assert set(chain) == {"0", "1"} and set(chain["0"]) == {"count", "mu", "nu"}
        assert set(chain["1"]) == {"count"}
        for count in (chain["0"]["count"], chain["1"]["count"]):
            assert count.shape == () and count.dtype == np.int32 and int(count) == 2
    for key, value in (("epoch", 0), ("it", 1)):
        assert tree[key].shape == () and tree[key].dtype == np.int64 and int(tree[key]) == value


# ---- configs/shapes.yaml at full width, state only -----------------------------

def _full_width_state(config, image_shape, steps_per_epoch, count):
    """The JAX package's TrainState at `config`'s widths without a forward:
    variable shapes from `jax.eval_shape` of the inits, seeded values;
    `create_train_state` with `make_optimizer`, moments set through
    `restore_adam_moments`."""
    generator, discriminator, kp_detector = jbuild.build_models(config)
    h, w, c = image_shape
    k = config["model_params"]["common_params"]["num_kp"]
    frame = jnp.zeros((1, 1, h, w, c))
    kp = {"mean": jnp.zeros((1, 1, k, 2)), "var": jnp.tile(jnp.eye(2) * 0.1, (1, 1, k, 1, 1))}
    key = jax.random.PRNGKey(0)
    shapes = {
        "generator": jax.eval_shape(lambda: generator.init(key, frame, kp, kp, False)),
        "discriminator": jax.eval_shape(lambda: discriminator.init(key, frame, kp, kp)),
        "kp_detector": jax.eval_shape(lambda: kp_detector.init(key, frame, False)),
    }
    rng = np.random.RandomState(0)

    def fill(tree, positive=False):
        return jax.tree.map(lambda s: (rng.uniform(0.5, 1.5, s.shape) if positive
                                       else rng.randn(*s.shape)).astype(np.float32), tree)

    params = {n: fill(v["params"]) for n, v in shapes.items()}
    batch_stats = {n: fill(shapes[n]["batch_stats"], positive=True)
                   for n in ("generator", "kp_detector")}
    tp = config["train_params"]
    optimizer = jtrain.make_optimizer(
        jtrain.multistep_lr(tp["lr"], tp["epoch_milestones"], steps_per_epoch))
    state = jtrain.create_train_state(params, batch_stats, optimizer)
    opt_states = {n: jtrain.restore_adam_moments(state.opt_states[n], count, fill(params[n]),
                                                 fill(params[n], positive=True))
                  for n in params}
    return state.replace(opt_states=opt_states, step=jnp.asarray(count - 1, jnp.int32))


FULL_WIDTH_STEPS_PER_EPOCH, FULL_WIDTH_COUNT = 200, 1234


@pytest.fixture(scope="module")
def full_width_file(tmp_path_factory):
    """configs/shapes.yaml's config, the JAX package's train state at count
    1234 (_full_width_state) and the checkpoint its save_checkpoint writes
    of it (train_loop._make_payload at epoch 6)."""
    config = yaml.safe_load((REPO / "configs" / "shapes.yaml").read_text())
    count = FULL_WIDTH_COUNT
    state = _full_width_state(config, (64, 64, 3), FULL_WIDTH_STEPS_PER_EPOCH, count)
    path = str(tmp_path_factory.mktemp("full_width") / "00000006-checkpoint.msgpack")
    jax_save_checkpoint(path, jloop._make_payload(state, 6, count - 1)())
    return config, state, path


def test_full_width_train_state_restores_bit_for_bit(full_width_file):
    """configs/shapes.yaml: the JAX package's checkpoint payload of a train
    state (train_loop._make_payload, save_checkpoint) loaded into the port's
    Trainer: parameters, batch statistics, Adam moments in the order each
    Adam holds its parameters, every step at the count, and the rate of the
    JAX schedule at the count (past the epoch-4 milestone)."""
    config, state, path = full_width_file
    tp = config["train_params"]
    steps_per_epoch, count = FULL_WIDTH_STEPS_PER_EPOCH, FULL_WIDTH_COUNT
    loaded = load_any(path)
    assert loaded["epoch"] == 6 and loaded["it"] == count - 1
    assert not any(key.startswith("scheduler_") for key in loaded)

    trainer = Trainer(build_train_models(config, device="cpu"), tp, device="cpu",
                      steps_per_epoch=steps_per_epoch)
    trainer.load_state_dict(loaded)
    lr = np.float32(jtrain.multistep_lr(tp["lr"], tp["epoch_milestones"], steps_per_epoch)(count))
    tensors = 0
    for name in MODEL_NAMES:
        params = jax.tree.map(np.asarray, state.params[name])
        want = from_jax_variables(params, jax.tree.map(np.asarray,
                                                       state.batch_stats.get(name, {})))
        got = trainer.models[name].state_dict()
        assert list(got) == list(trainer.models[name].state_dict())
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
            tensors += 1
        adam = state.opt_states[name][0]
        mu = from_jax_variables(jax.tree.map(np.asarray, adam.mu), {})
        nu = from_jax_variables(jax.tree.map(np.asarray, adam.nu), {})
        optimizer = trainer.optimizers[name]
        names = [n for n, _ in trainer.models[name].named_parameters()]
        params_in_order = optimizer.param_groups[0]["params"]
        assert len(params_in_order) == len(names)
        for pname, p in zip(names, params_in_order):
            entry = optimizer.state[p]
            assert entry["step"].item() == count
            assert torch.equal(entry["exp_avg"], mu[pname]), pname
            assert torch.equal(entry["exp_avg_sq"], nu[pname]), pname
            assert entry["exp_avg"].shape == p.shape
            tensors += 2
        assert trainer.schedulers[name].last_epoch == count
        assert np.float32(optimizer.param_groups[0]["lr"]) == lr
    assert lr == np.float32(tp["lr"] * 0.1)
    assert tensors > 600


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return {"shape": list(tree.shape), "dtype": tree.dtype.name}


@pytest.mark.parametrize("which", ["fixture", "full_width"])
def test_card_writer_reproduces_the_jax_package_bytes(which, full_width_file):
    """chip_smoke.pack_msgpack, which writes the card's full-width JAX file
    (the card has no flax), gives back the bytes of a file the JAX package
    wrote from its decoded tree: the committed fixture (its train()) and a
    configs/shapes.yaml train state (its save_checkpoint). The full-width
    file's layout is the committed JAX_SHAPES_LAYOUT that the card fills."""
    path = str(FIXTURE) if which == "fixture" else full_width_file[2]
    data = Path(path).read_bytes()
    tree = read_msgpack(path)
    assert chip_smoke.pack_msgpack(tree) == data
    if which == "full_width":
        layout = json.loads(chip_smoke.JAX_SHAPES_LAYOUT.read_text())
        assert _layout(serialization.msgpack_restore(data)) == layout


def test_card_file_of_the_shapes_layout_restores_into_trainer():
    """The full-width file the card writes (chip_smoke.jax_layout_tree at
    count 12, epoch 2; pack_msgpack): flax reads the tree that was packed,
    leaf for leaf; `load_any` gives each network's state and Adam moments,
    which a configs/shapes.yaml Trainer takes at the rate of the schedule at
    count 12 (4 steps an epoch: before the epoch-4 milestone)."""
    layout = json.loads(chip_smoke.JAX_SHAPES_LAYOUT.read_text())
    tree = chip_smoke.jax_layout_tree(layout, 12, 2)
    data = chip_smoke.pack_msgpack(tree)
    assert data == serialization.msgpack_serialize(jax.tree.map(np.asarray, tree))
    assert chip_smoke._same_tree(serialization.msgpack_restore(data), tree) > 600
    loaded = from_jax_checkpoint(msgpack_restore(data))
    assert loaded["epoch"] == 2 and loaded["it"] == 12
    config = yaml.safe_load((REPO / "configs" / "shapes.yaml").read_text())
    tp = config["train_params"]
    trainer = Trainer(build_train_models(config, device="cpu"), tp, device="cpu",
                      steps_per_epoch=4)
    trainer.load_state_dict(loaded)
    for name in MODEL_NAMES:
        steps = {entry["step"].item() for entry in trainer.optimizers[name].state.values()}
        assert steps == {12} and trainer.schedulers[name].last_epoch == 12
        assert trainer.optimizers[name].param_groups[0]["lr"] == tp["lr"]
        for key, value in trainer.models[name].state_dict().items():
            assert torch.isfinite(value.float()).all(), key


def test_adam_state_dict_refuses_moments_without_a_parameter():
    moments = {"step": 3, "exp_avg": {"a": torch.zeros(1), "b": torch.zeros(1)},
               "exp_avg_sq": {"a": torch.zeros(1), "b": torch.zeros(1)}}
    with pytest.raises(KeyError, match=r"missing \['c'\], no parameter for \['b'\]"):
        adam_state_dict(moments, ["a", "c"], {"lr": 1.0})
    with pytest.raises(ValueError, match="the Adam count 2 and the schedule's count 3"):
        from monkeynet_tpu_torch.utils.weights import from_optax_adam

        from_optax_adam({"0": {"count": np.asarray(2), "mu": {}, "nu": {}},
                         "1": {"count": np.asarray(3)}})


# ---- the fixture's tiny widths: eval, one resumed step, reconstruction, the CLI

def test_eval_networks_match_the_jax_package_from_its_file():
    """Both packages' load_eval_models read the JAX train checkpoint; both
    engines (keypoints of source and driving frames, move_location,
    generation) agree on the same frames to the model tests' limits."""
    config = _fixture_config()
    hw = 32
    models, gen_vars, kp_vars = jrecon.load_eval_models(config, str(FIXTURE), (hw, hw, 3))
    generator, kp_detector = trecon.load_eval_models(config, str(FIXTURE), device="cpu")
    rng = np.random.RandomState(5)
    source = rng.rand(1, 1, hw, hw, 3).astype(np.float32)
    driving = rng.rand(1, 6, hw, hw, 3).astype(np.float32)
    want = janimate.TransferEngine(models["generator"], models["kp_detector"], gen_vars,
                                   kp_vars, chunk=16)(jnp.asarray(source), jnp.asarray(driving))
    got = tanimate.TransferEngine(generator, kp_detector, chunk=16, device="cpu")(
        torch.from_numpy(source), torch.from_numpy(driving))
    for key in ("video_prediction", "video_deformed"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=OUT_ATOL,
                                   err_msg=key)
    for group in ("kp_driving", "kp_source", "kp_norm"):
        for k, tol in KP_ATOL.items():
            np.testing.assert_allclose(np.asarray(got[group][k]), np.asarray(want[group][k]),
                                       atol=tol, rtol=tol, err_msg=f"{group}.{k}")


def _resume_batch(hw=16, batch=2):
    rng = np.random.RandomState(11)
    return {"source": rng.rand(batch, 1, hw, hw, 3).astype(np.float32),
            "video": rng.rand(batch, 1, hw, hw, 3).astype(np.float32)}


def test_one_resumed_adam_step_matches_the_jax_package():
    """Both packages resume from the file and take one Adam step on the same
    batch, at the schedule's rate at count 2 (past the epoch-1 milestone):
    every parameter within 2 * lr of the JAX step and 98% of the entries
    within 1e-6; the running statistics likewise; every Adam step at 3."""
    config = _fixture_config()
    tp = config["train_params"]
    lr = tp["lr"] * 0.1
    loaded = read_msgpack(str(FIXTURE))["state"]
    optimizer = jtrain.make_optimizer(
        jtrain.multistep_lr(tp["lr"], tp["epoch_milestones"], FIXTURE_STEPS_PER_EPOCH))
    template = jtrain.create_train_state(loaded["params"], loaded["batch_stats"], optimizer)
    state = jloop.restore_train_state(template, loaded)
    generator, discriminator, kp_detector = jbuild.build_models(config)
    jmodels = {"generator": generator, "discriminator": discriminator,
               "kp_detector": kp_detector}
    batch = _resume_batch()
    step = jax.jit(jtrain.make_train_step(jmodels, tp, optimizer))
    new_state, _ = step(jax.tree.map(jnp.asarray, state),
                        {k: jnp.asarray(v) for k, v in batch.items()})

    trainer = Trainer(build_train_models(config, device="cpu"), tp, device="cpu",
                      steps_per_epoch=FIXTURE_STEPS_PER_EPOCH)
    trainer.load_state_dict(load_any(str(FIXTURE)))
    assert all(o.param_groups[0]["lr"] == pytest.approx(lr) for o in trainer.optimizers.values())
    trainer.step({k: torch.from_numpy(v) for k, v in batch.items()})

    tol = 2 * lr + 1e-6
    gaps, moved = [], 0
    for name in MODEL_NAMES:
        before = from_jax_variables(loaded["params"][name], loaded["batch_stats"].get(name, {}))
        want = from_jax_variables(jax.tree.map(np.asarray, new_state.params[name]),
                                  jax.tree.map(np.asarray, new_state.batch_stats.get(name, {})))
        got = trainer.models[name].state_dict()
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            gap = (got[key] - w).abs()
            assert gap.max().item() <= tol, f"{name}.{key}: {gap.max().item()} > {tol}"
            if "running_" not in key:
                gaps.append(gap.flatten())
                moved += int(((w - before[key]).abs() > 0.5 * lr).sum())
        for entry in trainer.optimizers[name].state.values():
            assert entry["step"].item() == 3
    assert (torch.cat(gaps) <= 1e-6).float().mean() >= 0.98
    assert moved > 1000


@pytest.fixture(scope="module")
def small_shapes(tmp_path_factory):
    """data/shapes cut small: the first 8 train videos and 2 test videos,
    each cut to its first 8 frames, and the fixture's config over them."""
    from monkeynet_tpu_torch.data.io import read_video, write_stacked_png

    root = tmp_path_factory.mktemp("shapes")
    for split, n in (("train", 8), ("test", 2)):
        (root / split).mkdir()
        src = REPO / "data" / "shapes" / split
        for name in sorted(os.listdir(src))[:n]:
            write_stacked_png(str(root / split / name),
                              read_video(str(src / name), (64, 64, 3))[:8])
    config = _fixture_config(root)
    config["prediction_params"].update(num_frames=4, train_size=2, num_epochs=2)
    return root, config


def test_reconstruction_reads_the_jax_file(small_shapes, tmp_path):
    """reconstruction(..., device="cpu") from the .msgpack gives the metrics
    and frames it gives from the same networks written as a .pth.tar."""
    from monkeynet_tpu_torch.data.dataset import FramesDataset

    _, config = small_shapes
    dataset = FramesDataset(is_train=False, **config["dataset_params"])
    pth = str(tmp_path / "weights.pth.tar")
    loaded = load_any(str(FIXTURE))
    save_checkpoint(pth, {"generator": loaded["generator"],
                          "kp_detector": loaded["kp_detector"]})
    runs = {}
    for label, ckpt in (("msgpack", str(FIXTURE)), ("pth", pth)):
        runs[label] = trecon.reconstruction(config, str(tmp_path / label), dataset, ckpt,
                                            device="cpu")
        assert all(np.isfinite(v) for v in runs[label].values())
    assert runs["msgpack"] == runs["pth"]
    names = os.listdir(tmp_path / "pth" / "reconstruction" / "png")
    assert len(names) == 2
    for name in names:
        with Image.open(tmp_path / "msgpack" / "reconstruction" / "png" / name) as a, \
                Image.open(tmp_path / "pth" / "reconstruction" / "png" / name) as b:
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("mode", ["train", "reconstruction", "transfer", "prediction"])
def test_cli_runs_every_mode_from_the_jax_file(small_shapes, tmp_path, monkeypatch, capsys,
                                                mode):
    """`python -m monkeynet_tpu_torch.run --mode <mode> --checkpoint
    <.msgpack>` with the card's check answered with the CPU: train resumes
    the file's epoch 0 (2 steps, logged from the file's `it`, a new
    checkpoint beside it); the eval modes write their outputs beside it."""
    from monkeynet_tpu_torch import run
    from monkeynet_tpu_torch.utils import device as device_mod

    _, config = small_shapes
    config = copy.deepcopy(config)
    config["train_params"]["steps_per_dispatch"] = 1
    path = tmp_path / "fixture.yaml"
    path.write_text(yaml.safe_dump(config))
    ckpt = tmp_path / "run" / "00000000-checkpoint.msgpack"
    ckpt.parent.mkdir()
    shutil.copy(FIXTURE, ckpt)
    monkeypatch.setattr(device_mod, "require_device", lambda device: torch.device("cpu"))
    assert run.main(["--config", str(path), "--mode", mode, "--checkpoint", str(ckpt)]) == 0
    out = capsys.readouterr().out
    written = sorted(os.listdir(ckpt.parent))
    assert "fixture.yaml" in written
    if mode == "train":
        assert "00000000-checkpoint.pth.tar" in written
        rows = (ckpt.parent / "log.txt").read_text().splitlines()
        assert [int(r.split(")")[0]) for r in rows] == [1, 2]
        resumed = torch.load(ckpt.parent / "00000000-checkpoint.pth.tar", weights_only=True)
        assert resumed["it"] == 2 and resumed["epoch"] == 0
        assert all(s["step"].item() == 4 for s in
                   resumed["optimizer_generator"]["state"].values())
    elif mode == "reconstruction":
        assert "Reconstruction loss:" in out
        assert len(os.listdir(ckpt.parent / mode / "png")) == 2
    else:
        assert os.listdir(ckpt.parent / mode / "png")
