"""The port's benchmark (monkeynet_tpu_torch/bench.py) on the CPU.

(a) `init_models_variables`, the JAX package's `init_models(config,
    PRNGKey(0), ...)` drawn in numpy, equals it leaf for leaf and bit for bit
    at the tests' tiny config: the generator, the kp detector, the
    discriminator and the batch statistics.
(b) The port's TransferEngine on those weights (through
    `from_jax_variables`) against the JAX package's TransferEngine on its
    own init, on bench.py's RandomState(0) inputs at chunk 4 over 8 frames,
    f32, to 1e-4 (tests/test_torch_port_models.py's OUT_ATOL).
(c) The bench's inputs and constants are bench.py's (numpy only).
(d) The FLOP counter's figures equal a count from the Conv3D layers' shapes
    (chip_smoke.layer_conv_flops; the backward rule in its docstring) on a
    first transfer chunk and on an eager train step, and leave out the
    plain versions' einsums that the counter sees on the CPU.
(e) The whole bench at the tiny config on the CPU, a few frames and steps,
    the sustained loop over the first videos of data/actions: a line that
    json.loads reads with every key of bench.py's line and the card's
    extras; the line's head on fixed rates, a rounding boundary among them.
(f) The `loader` mode's line on configs/shapes.yaml at 2 batches.

The JAX package's init_models runs once (~12 s at the tiny widths), in a
module fixture.
"""

import copy
import io
import json
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
import chip_smoke
from monkeynet_tpu.tasks import animate as janimate
from monkeynet_tpu.tasks.build import init_models
from monkeynet_tpu_torch import bench
from monkeynet_tpu_torch.tasks import animate as tanimate
from monkeynet_tpu_torch.tasks.build import build_models, build_train_models
from monkeynet_tpu_torch.tasks.train import Trainer
from monkeynet_tpu_torch.utils.config import load_config
from monkeynet_tpu_torch.utils.flax_init import init_models_variables

from .torch_port_common import tiny_config

REPO = Path(__file__).resolve().parents[1]
HW = 32
OUT_ATOL = 1e-4
# |vs_baseline * 100 - value| in frames/s: 0.05 (vs_baseline's third place)
# + 0.005 (value's second) + float slack
HEAD_SLACK = 0.056
# bench.py's line: its top-level keys and every key of its `extra`
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {
    "device_kind", "train_steps_per_sec_taichi_b32", "train_spread_pct",
    "sustained_steps_per_sec_actions", "sustained_loop_steps",
    "sustained_wall_seconds_incl_compile", "fps_median", "spread_pct", "n_runs",
    "compile_seconds", "compile_cache", "transfer_gflop_per_frame_measured",
    "transfer_mfu_vs_bf16_peak", "train_hw_gflop_per_step_executed",
    "train_hw_mfu_vs_bf16_peak", "train_gflop_per_step_measured", "train_mfu_vs_bf16_peak",
}
CARD_KEYS = {"nvidia_smi", "torch", "cuda", "peak_flops_bf16", "peak_source",
             "transfer_launches_per_pass", "train_launches_per_step", "train_captured_launches",
             "transfer_peak_mem_gb", "train_graph_peak_mem_gb", "train_eager_peak_mem_gb",
             "transfer_f32", "train_eager_steps_per_sec", "kernel_build_seconds",
             "transfer_flops_per_frame", "train_flops_per_step"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def inits():
    """The JAX package's init_models at PRNGKey(0) and the numpy draw."""
    config = tiny_config()
    models, params, batch_stats = init_models(config, jax.random.PRNGKey(0), (HW, HW, 3))
    return config, models, (params, batch_stats), init_models_variables(config, (HW, HW, 3))


@pytest.mark.parametrize("collection,network", [
    ("params", "generator"), ("params", "kp_detector"), ("params", "discriminator"),
    ("batch_stats", "generator"), ("batch_stats", "kp_detector")])
def test_init_models_variables_equal_the_jax_init_bit_for_bit(inits, collection, network):
    _, _, want, got = inits
    index = 0 if collection == "params" else 1
    w, g = dict(_leaves(want[index][network])), dict(_leaves(got[index][network]))
    assert set(g) == set(w) and w
    for path, value in w.items():
        assert g[path].dtype == value.dtype == np.float32, path
        np.testing.assert_array_equal(g[path], value, err_msg="/".join(path))
    assert set(got[1]) == set(want[1]) == {"generator", "kp_detector"}


def test_init_models_variables_refuses_other_channels():
    with pytest.raises(ValueError, match="channels"):
        init_models_variables(tiny_config(), (HW, HW, 1))


def test_transfer_on_the_bench_weights_matches_jax(inits):
    """The slice as a whole on bench.py's weights and inputs."""
    config, models, (params, batch_stats), variables = inits
    source, driving = bench.transfer_inputs(8, HW)
    engine = janimate.TransferEngine(
        models["generator"], models["kp_detector"],
        {"params": params["generator"], "batch_stats": batch_stats["generator"]},
        {"params": params["kp_detector"], "batch_stats": batch_stats["kp_detector"]},
        chunk=4, dtype=jnp.float32, move_location=True)
    want = engine(jnp.asarray(source), jnp.asarray(driving))
    generator, kp_detector = build_models(config, device="cpu")
    bench.load_variables({"generator": generator, "kp_detector": kp_detector}, variables)
    got = tanimate.TransferEngine(generator, kp_detector, chunk=4, dtype=torch.float32,
                                  move_location=True, device="cpu")(
        torch.from_numpy(source), torch.from_numpy(driving))
    for key in ("video_prediction", "video_deformed"):
        assert got[key].shape == (1, 8, HW, HW, 3)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=OUT_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["kp_norm"]["mean"].numpy(),
                               np.asarray(want["kp_norm"]["mean"]), atol=1e-5)


def test_inputs_and_constants_are_bench_pys():
    for name in ("V100_EST_FPS", "CHUNK", "N_FRAMES", "H", "W", "RUNS", "TRAIN_BATCH",
                 "TRAIN_STEPS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    # bench.py _bench_transfer and _bench_train, statement for statement
    rng = np.random.RandomState(0)
    source = rng.rand(1, 1, jax_bench.H, jax_bench.W, 3).astype(np.float32)
    driving = rng.rand(1, jax_bench.N_FRAMES, jax_bench.H, jax_bench.W, 3).astype(np.float32)
    got = bench.transfer_inputs()
    np.testing.assert_array_equal(got[0], source)
    np.testing.assert_array_equal(got[1], driving)
    rng = np.random.RandomState(0)
    batch = {
        "source": rng.rand(jax_bench.TRAIN_BATCH, 1, jax_bench.H, jax_bench.W, 3)
        .astype(np.float32),
        "video": rng.rand(jax_bench.TRAIN_BATCH, 1, jax_bench.H, jax_bench.W, 3)
        .astype(np.float32),
    }
    got = bench.train_batch()
    assert list(got) == list(batch)
    for k in batch:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], batch[k])


def test_peak_table_knows_the_h100_and_guesses_nothing():
    assert bench.peak_flops("NVIDIA H100 80GB HBM3")[0] == 989e12
    peak, source = bench.peak_flops("NVIDIA A100-SXM4-80GB")
    assert peak is None and "no bf16 peak" in source


def test_flop_count_equals_the_layers_shapes_on_a_transfer_chunk(inits):
    config, _, _, variables = inits
    generator, kp_detector = build_models(config, device="cpu")
    bench.load_variables({"generator": generator, "kp_detector": kp_detector}, variables)
    engine = tanimate.TransferEngine(generator, kp_detector, chunk=4, dtype=torch.float32,
                                     device="cpu")
    source, driving = (torch.from_numpy(a) for a in bench.transfer_inputs(4, HW))
    counted = bench.conv_flops(lambda: engine(source, driving))
    want = chip_smoke.layer_conv_flops([engine.generator, engine.kp_detector],
                                       lambda: engine(source, driving))
    assert counted == want > 0
    # the first down block of the kp detector on 5 frames (source + 4): 3 -> 8
    # channels, 3 x 3, 32^2
    assert want > 2 * 5 * HW * HW * 8 * 3 * 9
    # the CPU's plain versions add einsums the counter sees and the conv
    # count leaves out
    with torch.utils.flop_counter.FlopCounterMode(display=False) as everything:
        engine(source, driving)
    assert everything.get_total_flops() > counted


def test_flop_count_equals_the_layers_shapes_on_a_train_step(inits):
    config, _, _, variables = inits
    models = build_train_models(config, device="cpu")
    bench.load_variables(models, variables)
    trainer = Trainer(models, config["train_params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in bench.train_batch(2, HW).items()}
    counted = bench.conv_flops(lambda: trainer.step(batch))
    want = chip_smoke.layer_conv_flops(list(models.values()), lambda: trainer.step(batch))
    forward = chip_smoke.layer_conv_flops(
        list(models.values()), lambda: trainer.objective(batch)[0].detach())
    assert counted == want
    # forward and backward: the backward is between one and two forwards
    # (less where an input or a frozen weight needs no gradient, more for
    # the grouped convs' weights), here about twice
    assert 2.5 * forward < want < 4 * forward


def _sustained():
    """The tiny networks on configs/actions.yaml's data path over its first
    8 train videos: the device feed, uint8, 2 steps a dispatch."""
    actions = load_config(str(REPO / "configs" / "actions.yaml"))
    config = tiny_config()
    config["dataset_params"] = copy.deepcopy(actions["dataset_params"])
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "actions")
    config["train_params"].update(
        batch_size=4, device_feed=True, feed_dtype="uint8", steps_per_dispatch=2,
        num_workers=1, log_params={"log_freq_iter": 200, "cpk_freq_epoch": 5000})
    dataset = bench._dataset(config)
    dataset.images = dataset.images[:8]
    return config, dataset


def test_bench_line_on_the_cpu():
    config = tiny_config()
    sustained_config, dataset = _sustained()
    sizes = bench.Sizes(n_frames=8, chunk=4, runs=2, hw=HW, batch=2, train_steps=2,
                        train_blocks=2, eager_warmup=1, eager_steps=2, sustained_steps=4)
    line = json.loads(json.dumps(bench.run(config, sustained_config, dataset, device="cpu",
                                           sizes=sizes)))
    assert set(line) == LINE_KEYS
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"] == "transfer_frames_per_sec_per_chip_taichi64"
    assert line["unit"] == "frames/s" and line["value"] > 0
    # each field is one rounding of the unrounded rate: they agree to half a
    # unit in vs_baseline's third place plus half a unit in value's second
    assert abs(line["vs_baseline"] * bench.V100_EST_FPS - line["value"]) <= HEAD_SLACK
    extra = line["extra"]
    assert EXTRA_KEYS | CARD_KEYS <= set(extra)
    assert extra["device_kind"] == "cpu" and extra["n_runs"] == 2
    for key in ("train_steps_per_sec_taichi_b32", "sustained_steps_per_sec_actions",
                "fps_median", "train_eager_steps_per_sec", "transfer_gflop_per_frame_measured"):
        assert np.isfinite(extra[key]) and extra[key] > 0, key
    assert extra["sustained_loop_steps"] == 4
    assert extra["sustained_detail"]["steps_per_dispatch"] == 2
    assert extra["sustained_detail"]["device_feed"] is True
    assert 0 < extra["sustained_detail"]["first_chunk_s"] < extra["sustained_detail"]["loop_wall_s"]
    # no peak for the CPU: MFU null, and said so
    for key in ("transfer_mfu_vs_bf16_peak", "train_mfu_vs_bf16_peak",
                "train_hw_mfu_vs_bf16_peak"):
        assert extra[key] is None
    assert "no bf16 peak" in extra["peak_source"]
    assert extra["train_hw_gflop_per_step_executed"] == extra["train_gflop_per_step_measured"]
    # the wrappers count kernel launches only: the CPU launched none
    assert set(extra["transfer_launches_per_pass"].values()) == {0}


@pytest.mark.parametrize("fps, value, vs_baseline, boundary", [
    # the hundredths on a boundary: round(539.05 / 100, 3) is 5.39
    (539.0508031418598, 539.05, 5.391, True),
    (412.3456, 412.35, 4.123, False),
    (100.0, 100.0, 1.0, False),
])
def test_headline_rounds_the_unrounded_rate_once(fps, value, vs_baseline, boundary):
    """bench.py's arithmetic: value = round(fps, 2), vs_baseline =
    round(fps / 100, 3), both of the unrounded rate, in bench.py's key
    order; re-rounding the rounded value differs exactly on a boundary."""
    head = bench.headline(fps)
    assert list(head) == ["metric", "value", "unit", "vs_baseline"]
    assert head["metric"] == "transfer_frames_per_sec_per_chip_taichi64"
    assert head["unit"] == "frames/s"
    assert head["value"] == value == round(fps, 2)
    assert head["vs_baseline"] == vs_baseline == round(fps / jax_bench.V100_EST_FPS, 3)
    assert abs(head["vs_baseline"] * bench.V100_EST_FPS - head["value"]) <= HEAD_SLACK
    assert (round(head["value"] / bench.V100_EST_FPS, 3) != head["vs_baseline"]) is boundary


def test_check_launches_refuses_a_missing_or_stray_kernel():
    counts = {"warp": 6, "warp_dsrc": 0, "warp_dgrid": 0, "combine": 1, "softargmax": 1,
              "heatmap": 4}
    bench.check_launches("transfer", counts, bench.TRANSFER_KERNELS)
    for name, n in (("heatmap", 0), ("warp_dsrc", 5)):
        with pytest.raises(AssertionError, match="plain version"):
            bench.check_launches("transfer", dict(counts, **{name: n}), bench.TRANSFER_KERNELS)


def test_loader_mode_prints_bench_loaders_line():
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench.main(["loader", "--config", "configs/shapes.yaml", "--batches", "2",
                           "--workers", "2"]) == 0
    (line,) = out.getvalue().strip().splitlines()
    m = re.fullmatch(r"loader: (\S+) batches/s \((\S+) items/s\) at batch_size=16 workers=2 "
                     r"\((\S+) ms/batch\)", line)
    assert m and all(float(v) > 0 for v in m.groups()), line
