"""JAX package variables -> the port's state_dict.

The JAX package keeps flax pytrees in channels-last layouts; the port keeps
the reference's state_dict names and layouts. `from_jax_variables` maps one
model's `params` and `batch_stats` (as numpy arrays) to a state_dict that
`load_state_dict` takes, so both packages compute with the same weights.
Names follow the reference's checkpoint keys:
  conv kernel (kh, kw, in/g, out)  -> `<path>.weight` (out, in/g, 1, kh, kw)
  conv bias                        -> `<path>.bias`
  norm scale / bias                -> `<path>.weight` / `<path>.bias`
                                      (batch norms and the discriminator's
                                      instance norms alike)
  batch_stats mean / var           -> `<path>.running_mean` / `.running_var`
A bare `Encoder` tree (the frozen AED embedder's) maps the same way, to an
`Encoder`'s state_dict. The keypoint predictor's tree maps to its
`torch.nn.GRU` and head:
  gru{l} weight_ih / weight_hh / bias_ih / bias_hh
                                   -> `gru.weight_ih_l{l}` ... (both in
                                      torch's layout and [r, z, n] order)
  head kernel (in, out) / bias     -> `head.weight` (out, in) / `head.bias`
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"down(\d+)"), "down_blocks.{}"),
    (re.compile(r"up(\d+)"), "up_blocks.{}"),
    (re.compile(r"refine(\d+)"), "refinement_module.r{}"),
    (re.compile(r"group_block(\d+)"), "group_blocks.{}"),
)


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(parts) -> str:
    out = []
    for p in parts:
        for pattern, fmt in _RENAMES:
            m = pattern.fullmatch(p)
            if m:
                out.append(fmt.format(m.group(1)))
                break
        else:
            if p == "dense_motion":
                out.append("dense_motion_module")
            elif p == "score_conv":
                out.append("conv")  # the discriminator's score head
            elif p == "final_conv":
                # the decoder's last conv, or the generator's refinement head
                out.append("conv" if out and out[-1] == "decoder" else "refinement_module.conv-last")
            else:
                out.append(p)
    return ".".join(out)


def _join(parts, name: str) -> str:
    prefix = _module_path(parts)
    return f"{prefix}.{name}" if prefix else name


def _key(path, collection: str) -> Tuple[str, str]:
    """(torch key, kind) for one flax leaf path."""
    parts = list(path)
    leaf = parts.pop()
    if collection == "params" and len(parts) == 1:
        gru = re.fullmatch(r"gru(\d+)", parts[0])
        if gru:
            return f"gru.{leaf}_l{gru.group(1)}", "plain"
        if parts[0] == "head" and leaf in ("kernel", "bias"):
            return f"head.{'weight' if leaf == 'kernel' else 'bias'}", (
                "dense" if leaf == "kernel" else "plain")
    if collection == "batch_stats":
        return _join(parts, f"running_{leaf}"), "stat"
    if parts and parts[-1] == "conv" and leaf in ("kernel", "bias"):
        # Conv3D's inner conv: (.., block, 'conv', leaf) -> block.weight/bias
        parts.pop()
        return _join(parts, "weight" if leaf == "kernel" else "bias"), leaf
    if leaf in ("scale", "bias"):
        return _join(parts, "weight" if leaf == "scale" else "bias"), "norm"
    raise KeyError(f"no port parameter for flax {collection}:{'/'.join(path)}")


def from_jax_variables(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One model's flax `params` and `batch_stats` -> the port's state_dict
    (f32 tensors, plus num_batches_tracked = 0 for every norm)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _leaves(tree):
            key, kind = _key(path, collection)
            v = np.asarray(value, dtype=np.float32)
            if kind == "kernel":
                if v.ndim != 4:
                    raise ValueError(f"{key}: expected a (kh, kw, in, out) kernel, got {v.shape}")
                v = v.transpose(3, 2, 0, 1)[:, :, None]  # (out, in/g, 1, kh, kw)
            elif kind == "dense":
                v = v.T  # (in, out) -> (out, in)
            sd[key] = torch.tensor(v)
            if kind == "stat" and key.endswith("running_mean"):
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd
