"""Every kernel of the program has a kind and a byte bound; the model FLOPs
of both configurations, counted on the reference."""

from __future__ import annotations

import json
import re

import pytest

from benchmarks import flops, kernels
from benchmarks.tests import fixture

CSRC = fixture.REPO / "monkeynet_tpu_torch" / "csrc"


def _globals():
    names = set()
    for path in CSRC.glob("*.cu"):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(\w+)", text))
    return names


def test_every_kernel_has_a_kind_and_a_bound():
    found = _globals()
    assert {"warp_dsrc_bin_kernel", "warp_dsrc_sort_kernel", "warp_dsrc_gather_kernel",
            "softargmax_split_kernel", "softargmax_merge_kernel"} <= found
    assert found == set(kernels.OPS)
    shapes = {"B": 2, "D": 3, "H": 8, "W": 8, "C": 4, "N": 50, "K": 5}
    for name in found:
        assert kernels.kind_of(f"void {name}<float, 4>(float const*, int)") == "port_kernels"
        assert kernels.op_bytes(kernels.OPS[name], shapes, 2) > 0


def test_kinds_of_library_kernels():
    assert kernels.kind_of("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32") == "convolution"
    assert kernels.kind_of("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert kernels.kind_of("void at::native::reduce_kernel<512, 1>") == "reduction"
    assert kernels.port_kernel("void warp_dsrc_kernel_x") is None
    assert kernels.port_kernel("void warp_fwd_kernel_vector<__nv_bfloat16, int>(int)") == \
        "warp_fwd_kernel_vector"


def _config(name):
    return json.loads((fixture.REPO / "benchmarks" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, per_video, per_frame, step", [
    ("taichi64", 2621030400, 6849339392, 1031472562176),
    ("vox256", 13403013120, 51000393728, 5914580920320),
])
def test_model_flops(name, per_video, per_frame, step):
    cfg = _config(name)
    hw = tuple(cfg["image_size"])
    assert flops.transfer_flops(cfg["model_params"], hw) == (per_video, per_frame)
    assert flops.train_step_flops(cfg["model_params"], cfg["train_params"], hw,
                                  cfg["train_params"]["batch_size"]) == step


def test_path_ops_count_the_programs_launches():
    cfg = _config("taichi64")
    mp = cfg["model_params"]
    chunk = [op for op, _ in kernels.path_ops(mp, (64, 64), "transfer_chunk", frames=128)]
    assert chunk.count("warp") == 6 and chunk.count("heatmap") == 4
    assert chunk.count("combine") == 1 and chunk.count("softargmax") == 1
    step = [op for op, _ in kernels.path_ops(mp, (64, 64), "train_step", batch=32)]
    assert [step.count(op) for op in ("warp_fwd", "warp_dsrc", "warp_dgrid", "combine")] == \
        [6, 5, 6, 1]
    vox = _config("vox256")
    step = [op for op, _ in kernels.path_ops(vox["model_params"], (256, 256), "train_step",
                                             batch=20, remat=True)]
    assert [step.count(op) for op in ("warp_fwd", "warp_dsrc", "warp_dgrid", "combine")] == \
        [16, 7, 8, 2]
