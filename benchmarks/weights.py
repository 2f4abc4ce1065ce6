"""Seeded weights for both sides, drawn on the device.

Every parameter of a network comes from one `torch.randn` call on the card:
a conv's weight at std 1/sqrt(fan_in), its bias at 0.1, a norm's scale at
1 + 0.1 z and its shift at 0.1 z. Drawn weights alone would leave the
eval-mode batch norms' running statistics at 0 and 1, far from what the
activations hold, and the heads unscaled, so predictions would saturate and
a comparison would prove little. So the draw is calibrated on seeded frames
by the reference model (benchmarks/reference), never by the program:

- each batch norm's running statistics are set to the statistics of its
  input on a calibration clip (one training-mode forward, in which every
  norm normalises by its batch's statistics, so later norms see what they
  will see in eval);
- the heads without a norm after them are rescaled: the keypoint logits to
  std KP_LOGIT_STD (the soft-argmax divides them by its temperature, 0.1),
  the dense-motion mask logits to std 1 and its flow correction to
  CORRECTION_STD (in units of the [-1, 1] grid), and the generator's last
  conv to std OUTPUT_STD before its sigmoid, each with zero mean per channel.

The same state_dicts are loaded into the program and into the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmarks.reference import model as reference

KP_LOGIT_STD = 0.1
MASK_LOGIT_STD = 1.0
CORRECTION_STD = 0.02
OUTPUT_STD = 1.5


def _fill(net: torch.nn.Module, gen: torch.Generator) -> None:
    slots = []
    for module in net.modules():
        if isinstance(module, reference.Conv):
            fan_in = math.prod(module.weight.shape[1:])
            slots += [(module.weight, 1.0 / math.sqrt(fan_in), 0.0), (module.bias, 0.1, 0.0)]
        elif isinstance(module, (reference.BatchNorm, reference.InstanceNorm)):
            slots += [(module.weight, 0.1, 1.0), (module.bias, 0.1, 0.0)]
    total = sum(p.numel() for p, _, _ in slots)
    z = torch.randn(total, generator=gen, device=slots[0][0].device)
    offset = 0
    with torch.no_grad():
        for p, scale, shift in slots:
            p.copy_(z[offset:offset + p.numel()].view_as(p) * scale + shift)
            offset += p.numel()


def _output_of(module, fn):
    """The output of `module` during fn()."""
    seen = []
    handle = module.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        fn()
    finally:
        handle.remove()
    return seen[-1]


@torch.no_grad()
def _rescale(conv, out, rows: slice, std: float) -> None:
    """Scale conv's output channels `rows` to `std` with zero mean, from its
    output `out` (..., C) on the calibration clip."""
    y = out[..., rows].float().reshape(-1, out[..., rows].shape[-1])
    gain = std / y.std(dim=0).clamp(min=1e-12)
    conv.weight[rows] *= gain[:, None, None, None, None]
    conv.bias[rows] = (conv.bias[rows] - y.mean(dim=0)) * gain


def _calibrating(net, on: bool) -> None:
    for m in net.modules():
        if isinstance(m, reference.BatchNorm):
            m.calibrate = on


@torch.no_grad()
def draw(model_params: Dict, seed: int, clip: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'kp_detector', 'generator', 'discriminator'} state_dicts on the CPU,
    drawn from `seed` on clip's device and calibrated on `clip`
    (D, H, W, 3) f32 frames in [0, 1]: its first frame is the source."""
    device = clip.device
    nets = reference.build(model_params, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name in ("kp_detector", "generator", "discriminator"):
        _fill(nets[name], gen)
    kp_det, generator = nets["kp_detector"], nets["generator"]
    source, driving = clip[None, :1], clip[None]

    _calibrating(kp_det, True)
    kp_det.train()(driving)
    _calibrating(kp_det, False)
    kp_det.eval()
    head = kp_det.predictor.decoder.conv
    _rescale(head, _output_of(head, lambda: kp_det(driving)), slice(None), KP_LOGIT_STD)
    kp_source, kp_driving = kp_det(source), kp_det(driving)

    motion = generator.dense_motion_module
    K1 = motion.num_kp + 1
    _calibrating(generator, True)
    head = motion.hourglass.decoder.conv
    out = _output_of(head, lambda: motion.train()(source, kp_driving, kp_source))
    _rescale(head, out, slice(0, K1), MASK_LOGIT_STD)
    _rescale(head, out, slice(K1, K1 + 2), CORRECTION_STD)
    last = generator.refinement_module[-1]
    out = _output_of(last, lambda: generator.train()(source, kp_driving, kp_source))
    _rescale(last, out, slice(None), OUTPUT_STD)
    _calibrating(generator, False)
    return {name: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
            for name, net in nets.items()}
