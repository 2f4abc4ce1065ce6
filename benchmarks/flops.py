"""Model FLOPs of a configuration, counted once on the reference.

`torch.utils.flop_counter.FlopCounterMode` over the frozen reference
(benchmarks/reference) on the `meta` device: convolutions and matrix
products as the model defines them (a decoder block upsamples, then
convolves), forward and, for a train step, backward, each counted once: no
recomputation. How the program computes a layer does not change the count.

PEAK_FLOPS is the card's dense peak in the compute dtype, by the name that
`torch.cuda.get_device_name()` gives (NVIDIA's H100 SXM data sheet, 700 W).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.reference import model as reference
from benchmarks.reference import train as reference_train

PEAK_FLOPS = {
    ("NVIDIA H100 80GB HBM3", "bfloat16"): 989e12,
    ("NVIDIA H100 80GB HBM3", "float32"): 67e12,
}


def peak(device_name: str, dtype_name) -> float:
    """The card's dense peak in FLOP/s, or None where the table has none."""
    return PEAK_FLOPS.get((device_name, dtype_name or "float32"))


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def transfer_flops(model_params: Dict, hw: Tuple[int, int]) -> Tuple[int, int]:
    """(FLOPs a video pays once, FLOPs a driving frame): the source's
    keypoints and the generator's per-call work, and the keypoints and the
    generator of one more frame."""
    H, W = hw
    K = model_params["common_params"]["num_kp"]
    nets = reference.build(model_params, device="meta")
    for net in nets.values():
        net.eval()

    def video(frames):
        kp = {"mean": _meta(1, frames, K, 2), "var": _meta(1, frames, K, 2, 2)}
        src = {k: v[:, :1] for k, v in kp.items()}
        nets["kp_detector"](_meta(1, frames, H, W, 3))
        nets["generator"](_meta(1, 1, H, W, 3), kp, src)

    one, two = _count(lambda: video(1)), _count(lambda: video(2))
    source = _count(lambda: nets["kp_detector"](_meta(1, 1, H, W, 3)))
    per_frame = two - one
    return one - per_frame + source, per_frame


def train_step_flops(model_params: Dict, train_params: Dict, hw: Tuple[int, int],
                     batch: int) -> int:
    """FLOPs of one train step at `batch`: the objective and its gradients."""
    H, W = hw
    nets = reference.build(model_params, device="meta")
    for net in nets.values():
        net.train()
    params = {n: {k: p.detach().requires_grad_() for k, p in nets[n].named_parameters()}
              for n in reference_train.NAMES}
    data = {"source": _meta(batch, 1, H, W, 3), "video": _meta(batch, 1, H, W, 3)}

    def step():
        total = reference_train.objective(nets, params, data, train_params)[0]
        flat = [p for n in reference_train.NAMES for p in params[n].values()]
        torch.autograd.grad(total, flat, allow_unused=True)

    return _count(step)
