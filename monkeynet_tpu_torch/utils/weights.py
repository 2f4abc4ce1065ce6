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
A network's optax chain state (the JAX package's `make_optimizer`: Adam
then the scheduled rate) maps to a `torch.optim.Adam` state through
`from_optax_adam` and `adam_state_dict`: its moments through the same
names and layouts as the parameters, its count to Adam's step.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Tuple

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


def _as_f32(value, where: str) -> np.ndarray:
    """A floating leaf as an f32 array. The port's weights are f32: a bf16 or
    f16 leaf widens exactly and an f64 one rounds to the nearest f32; any
    other dtype raises."""
    if isinstance(value, torch.Tensor):  # a bf16 leaf (utils/msgpack.py)
        if not value.is_floating_point():
            raise TypeError(f"{where}: a {value.dtype} leaf where a float was expected")
        return value.to(torch.float32).numpy()
    v = np.asarray(value)
    if v.dtype.kind != "f":
        raise TypeError(f"{where}: a {v.dtype} leaf where a float was expected")
    return v.astype(np.float32)


def from_jax_variables(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One model's flax `params` and `batch_stats` -> the port's state_dict
    (f32 tensors, plus num_batches_tracked = 0 for every norm: the JAX
    package keeps no such count, and a batch norm with a momentum never
    reads it)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _leaves(tree):
            key, kind = _key(path, collection)
            v = _as_f32(value, f"flax {collection}:{'/'.join(path)}")
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


def from_optax_adam(chain_state: Mapping[str, Any]) -> Dict[str, Any]:
    """One network's optax chain state, as flax serialises the JAX package's
    `make_optimizer` (monkeynet_tpu/tasks/train.py): {'0': {'count', 'mu',
    'nu'}} for `scale_by_adam` and {'1': {'count'}} for the scheduled rate.
    Returns {'step': the count, 'exp_avg': {torch key: mu}, 'exp_avg_sq':
    {torch key: nu}}, the moments under the parameters' names and layouts.
    After n updates optax's count and torch's Adam step both read n, so the
    bias corrections agree. The two counts must agree: the rate's count is
    the step the schedule reads, and the port's MultiStepLR resumes at
    Adam's."""
    adam, rate = chain_state["0"], chain_state.get("1", {})
    count = int(np.asarray(adam["count"]))
    if "count" in rate and int(np.asarray(rate["count"])) != count:
        raise ValueError(f"the Adam count {count} and the schedule's count "
                         f"{int(np.asarray(rate['count']))} differ")
    return {"step": count, "exp_avg": from_jax_variables(adam["mu"], {}),
            "exp_avg_sq": from_jax_variables(adam["nu"], {})}


def adam_state_dict(moments: Mapping[str, Any], names: List[str],
                    param_group: Mapping[str, Any]) -> Dict[str, Any]:
    """`from_optax_adam`'s moments as a `torch.optim.Adam` state_dict over
    the parameters `names` (a network's `named_parameters()` order, the
    order its optimizer holds them in), with the hyperparameters of
    `param_group`. The step is an f32 CPU tensor, as an eager Adam keeps
    it. A parameter without moments, or moments without a parameter,
    raise."""
    have = set(moments["exp_avg"])
    if have != set(names) or set(moments["exp_avg_sq"]) != have:
        missing, extra = sorted(set(names) - have), sorted(have - set(names))
        raise KeyError(f"optimizer moments do not match the network's parameters: "
                       f"missing {missing[:5]}, no parameter for {extra[:5]}")
    state = {i: {"step": torch.tensor(float(moments["step"])),
                 "exp_avg": moments["exp_avg"][name].clone(),
                 "exp_avg_sq": moments["exp_avg_sq"][name].clone()}
             for i, name in enumerate(names)}
    group = {k: v for k, v in param_group.items() if k != "params"}
    return {"state": state, "param_groups": [dict(group, params=list(range(len(names))))]}
