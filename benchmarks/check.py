"""The numbers that decide `correct`, and the reference runs behind them.

Transfer (answers checked one by one): for a sample of the videos finished
in the window, drawn from the seed and holding the longest, the reference
animates the same source with the same driving frames in float32, in chunks;
the numbers are the widest per-frame mean absolute gap of the predicted
pixels (`frame_mae_max`, pixels in [0, 1]) and its mean over every frame
compared (`frame_mae_mean`), and the widest gap of a keypoint coordinate
(`kp_gap_max`, in units of the [-1, 1] grid).

Train: the reference takes the program's first three steps from the same
weights on the same batches (set-up takes them through `Trainer.run`). The
numbers: each of the first step's loss terms as a relative gap
(`loss_terms_gap_first`, worst term) and its total (`loss_gap_first`; over
the three steps, `loss_gap`); the first step's generated frames and
keypoints, as transfer reads them (`frame_mae_first`, `kp_gap_first`); and,
leaf by leaf, the gap between the program's and the reference's norm of the
first step's gradient as Adam received it and of each parameter's change
over the three steps, against the reference's norm of that leaf or of the
network's median leaf, whichever is larger: the worst leaf (`grad_gap`,
`delta_gap`) and the median leaf (`grad_gap_median`, `delta_gap_median`).
Leaves whose reference gradient is under LEAF_FLOOR of the median leaf's (a
bias before a batch norm, which the norm cancels) move under Adam by
rounding alone and are left out of the change. What a gradient holds, and
not only its size, is read as its direction: leaf by leaf, the distance
between the program's and the reference's first gradient each scaled to
unit length (0 alike, about the angle in radians when small, 2 opposite),
over the leaves the reference moves; the median leaf (`grad_dir_median`,
and per network) and the same of the change over the three steps
(`delta_dir_median`). Adam's step does not see a leaf's gradient scaled as
a whole, so neither does this number; a gradient taken over other samples
points elsewhere. And how many of the leaves the reference moves get, in
the program, a first gradient under ZERO_SHARE of the reference's norm of
that leaf (`zero_grad_leaves`): a gradient left out where it is produced. A
cell compares the numbers its limits file names; the others are printed as
readings.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List

import torch

from benchmarks.reference import model as reference
from benchmarks.reference import train as ref_train

LEAF_FLOOR = 1e-3
ZERO_SHARE = 1e-3
REFERENCE_CHUNK = 64


def set_float32_exact() -> None:
    """Float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_nets(model_params, state, device, precision="f32"):
    nets = reference.build(model_params, reference.Ctx(precision),
                           device=device)
    for name, net in nets.items():
        net.load_state_dict(state[name])
        net.eval()
    return nets


@torch.no_grad()
def reference_transfer(nets, source, driving, device, chunk=REFERENCE_CHUNK):
    """source (1, 1, H, W, 3), driving (1, n, H, W, 3) float32 on the host ->
    (prediction (n, H, W, 3), keypoint means (n, K, 2)) on the host: the
    relative move_location transfer in float32, `chunk` frames at a time."""
    kp_det, gen = nets["kp_detector"], nets["generator"]
    src = source.to(device)
    kp_source = kp_det(src)
    preds, means, first = [], [], None
    for start in range(0, driving.shape[1], chunk):
        frames = driving[:, start:start + chunk].to(device)
        kp = kp_det(frames)
        if first is None:
            first = kp["mean"][:, :1]
        norm = dict(kp, mean=kp["mean"] - first + kp_source["mean"])
        preds.append(gen(src, norm, kp_source)["video_prediction"][0].cpu())
        means.append(kp["mean"][0].cpu())
    return torch.cat(preds), torch.cat(means)


def transfer_numbers(pairs: Iterable) -> Dict[str, float]:
    """pairs of ((prediction, kp means) of the program, the same of the
    reference), host tensors -> {'frame_mae_max', 'frame_mae_mean',
    'kp_gap_max'}: the widest and the mean over every frame of a frame's
    mean absolute gap, and the widest keypoint gap."""
    frame, kp, total, count = 0.0, 0.0, 0.0, 0
    for (pred, mean), (ref_pred, ref_mean) in pairs:
        gap = (pred.float() - ref_pred.float()).abs()
        per_frame = gap.reshape(gap.shape[0], -1).mean(dim=1)
        frame = max(frame, float(per_frame.max()))
        total, count = total + float(per_frame.sum()), count + per_frame.numel()
        kp = max(kp, float((mean.float() - ref_mean.float()).abs().max()))
    return {"frame_mae_max": frame, "frame_mae_mean": total / max(count, 1), "kp_gap_max": kp}


def _norms(tree):
    return {net: {k: float(v.float().norm()) for k, v in leaves.items()}
            for net, leaves in tree.items()}


def leaf_gaps(program: Dict, ref: Dict, leaves=None) -> List[float]:
    """Each leaf's |norm(program) - norm(reference)| over the larger of the
    reference's norm of that leaf and of the network's median leaf."""
    gaps = []
    p_norms, r_norms = _norms(program), _norms(ref)
    for net, norms in r_norms.items():
        median = statistics.median(norms.values())
        for k, r in norms.items():
            if leaves is not None and k not in leaves[net]:
                continue
            gap = abs(p_norms[net][k] - r) / max(r, median, 1e-30)
            gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def dir_gaps(program: Dict, ref: Dict, leaves=None) -> List[float]:
    """Each leaf's distance between the program's and the reference's
    tensor, each scaled to unit length (a zero tensor stays zero)."""
    gaps = []
    for net, tensors in ref.items():
        for k, r in tensors.items():
            if leaves is not None and k not in leaves[net]:
                continue
            p, r = program[net][k].double().flatten(), r.double().flatten()
            p_n, r_n = float(p.norm()), float(r.norm())
            gap = float((p / max(p_n, 1e-300) * (p_n > 0) - r / max(r_n, 1e-300) * (r_n > 0))
                        .norm())
            gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def zero_leaves(first_grads: Dict, ref_first: Dict, leaves: Dict) -> int:
    """How many of `leaves` have a program gradient under ZERO_SHARE of the
    reference's norm of that leaf."""
    p_norms, r_norms = _norms(first_grads), _norms(ref_first)
    return sum(1 for net in leaves for k in leaves[net]
               if not p_norms[net][k] >= ZERO_SHARE * r_norms[net][k])


def moving_leaves(first_grads: Dict) -> Dict[str, set]:
    """Per network, the leaves whose reference gradient is at least
    LEAF_FLOOR of the median leaf's."""
    out = {}
    for net, norms in _norms(first_grads).items():
        median = statistics.median(norms.values())
        out[net] = {k for k, n in norms.items() if n >= LEAF_FLOOR * median}
    return out


def train_numbers(losses: List[List[float]], first_grads: Dict, delta: Dict, outputs,
                  ref_losses: List[List[float]], ref_first: Dict, ref_delta: Dict, ref_outputs
                  ) -> Dict[str, float]:
    """losses: each step's loss terms (the generator's, then the
    discriminator's); first_grads and delta: {net: {leaf: tensor}} of the
    first step's gradient and the change over the steps; outputs: the first
    step's generated frames (B, 1, H, W, 3) and keypoint means."""
    grad = leaf_gaps(first_grads, ref_first)
    moving = moving_leaves(ref_first)
    change = leaf_gaps(delta, ref_delta, moving)
    totals, ref_totals = [sum(s) for s in losses], [sum(s) for s in ref_losses]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(totals, ref_totals)),
           "loss_gap_first": abs(totals[0] - ref_totals[0]) / abs(ref_totals[0]),
           "loss_terms_gap_first": max(abs(a - b) / abs(b)
                                       for a, b in zip(losses[0], ref_losses[0])),
           "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
           "delta_gap": max(change), "delta_gap_median": statistics.median(change),
           "grad_dir_median": statistics.median(dir_gaps(first_grads, ref_first, moving)),
           "delta_dir_median": statistics.median(dir_gaps(delta, ref_delta, moving)),
           "zero_grad_leaves": zero_leaves(first_grads, ref_first, moving)}
    frames = transfer_numbers([((outputs[0].flatten(0, 1), outputs[1]),
                                (ref_outputs[0].flatten(0, 1), ref_outputs[1]))])
    out["frame_mae_first"], out["kp_gap_first"] = frames["frame_mae_max"], frames["kp_gap_max"]
    for net in ref_first:  # read, not compared: which network moves the median
        out[f"grad_gap_median.{net}"] = statistics.median(
            leaf_gaps({net: first_grads[net]}, {net: ref_first[net]}))
        out[f"grad_dir_median.{net}"] = statistics.median(
            dir_gaps({net: first_grads[net]}, {net: ref_first[net]}, moving))
    return out


def reference_train(model_params, train_params, state, batches, device, precision="f32",
                    half_batch=False):
    """(losses (each step's loss terms), first gradients, change of the
    parameters, the first step's generated frames and keypoint means) of
    the reference's steps over `batches` ({'source', 'video'}
    uint8 (B, 1, H, W, 3), on the host) from `state`."""
    nets = reference.build(model_params, reference.Ctx(precision),
                           device=device)
    floats = [{k: v.to(device).float() / 255.0 for k, v in b.items()} for b in batches]
    losses, first, params, (fake, kp_mean) = ref_train.train_steps(
        nets, state, floats, train_params, half_batch=half_batch)
    delta = {n: {k: (p - state[n][k].to(device)).cpu() for k, p in params[n].items()}
             for n in params}
    first = {n: {k: g.cpu() for k, g in leaves.items()} for n, leaves in first.items()}
    return losses, first, delta, (fake.cpu(), kp_mean.cpu())
