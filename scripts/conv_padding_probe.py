"""cuDNN's channel-padding launches by convolution, on the card.

Runs one transfer chunk (TransferEngine) or one eager train step (Trainer,
no graph) of a benchmark configuration under torch.profiler and lists every
device kernel whose name holds 'addpadding' (cuDNN's copy of an NHWC input
whose channel count its tensor-core kernels cannot take into a padded
buffer) under the op that launched it: the op, its input shapes, launches
and device microseconds. Then the padding's total beside every
convolution kernel's, the --ops ops of most device time, and one JSON line
(with every device operation's count).
Weights are the networks' own seeded init (the padding depends on widths
alone). --root imports the networks of another checkout.

    python3 scripts/conv_padding_probe.py --config benchmarks/configs/vox256.json --path transfer
    python3 scripts/conv_padding_probe.py --config benchmarks/configs/vox256.json --path train
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict
from pathlib import Path

CONV = re.compile(r"conv|xmma|fprop|implicit|cudnn|wgrad|dgrad|winograd|nhwc|nchw")


def _launcher(event):
    """The nearest op at or above `event` that is a convolution's, else
    `event`."""
    e = event
    while e is not None:
        if "conv" in e.name:
            return e
        e = e.cpu_parent
    return event


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="a benchmarks/configs/*.json file")
    ap.add_argument("--path", choices=("transfer", "train"), default="transfer")
    ap.add_argument("--frames", type=int, default=128, help="transfer: frames in the chunk")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose networks to import (this one)")
    ap.add_argument("--ops", type=int, default=0, help="list the N ops of most device time")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import numpy as np
    import torch

    from monkeynet_tpu_torch.tasks.build import build_models, build_train_models

    if not torch.cuda.is_available():
        print("conv_padding_probe: needs a CUDA device", file=sys.stderr)
        return 2
    config = json.loads(open(args.config).read())
    H, W = config["image_size"]
    tp = config["train_params"]
    dtype = getattr(torch, tp.get("compute_dtype") or "float32")
    rng = np.random.RandomState(0)
    if args.path == "transfer":
        from monkeynet_tpu_torch.tasks.animate import TransferEngine

        generator, kp_detector = build_models(config, device="cuda")
        engine = TransferEngine(generator, kp_detector, chunk=args.frames, dtype=dtype,
                                device="cuda")
        source = rng.rand(1, 1, H, W, 3).astype(np.float32)
        driving = rng.rand(1, args.frames, H, W, 3).astype(np.float32)

        def work():
            engine(source, driving)
    else:
        from monkeynet_tpu_torch.tasks.train import Trainer

        trainer = Trainer(build_train_models(config, device="cuda"), tp, device="cuda")
        batch = {k: torch.from_numpy(rng.rand(tp["batch_size"], 1, H, W, 3).astype(np.float32))
                 for k in ("source", "video")}

        def work():
            trainer.step(batch)
    for _ in range(2):
        work()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        work()
        torch.cuda.synchronize()

    pads = defaultdict(lambda: [0, 0.0])
    pad_us = conv_us = 0.0
    launches = 0
    for event in prof.events():
        for kernel in getattr(event, "kernels", []):
            launches += 1
            low = kernel.name.lower()
            if CONV.search(low):
                conv_us += kernel.duration
            if "addpadding" in low:
                op = _launcher(event)
                entry = pads[(op.name, str(op.input_shapes), kernel.name[:60])]
                entry[0] += 1
                entry[1] += kernel.duration
                pad_us += kernel.duration
    print(f"{args.config} {args.path}: {torch.cuda.get_device_name()}, {dtype}")
    for (op, shapes, kernel), (n, us) in sorted(pads.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:10.1f} us  {n:3d}x  {op} {shapes}  [{kernel}]")
    print(f"  padding {pad_us:.1f} us of {conv_us:.1f} us of convolution kernels")
    if args.ops:
        ops = sorted(prof.key_averages(group_by_input_shape=True),
                     key=lambda a: -a.self_device_time_total)
        for a in ops[:args.ops]:
            print(f"  {a.self_device_time_total:10.1f} us  {a.count:4d}x  {a.key} "
                  f"{str(a.input_shapes)[:120]}")
    print(json.dumps({"config": args.config, "path": args.path, "padding_us": pad_us,
                      "padding_launches": sum(n for n, _ in pads.values()),
                      "conv_us": conv_us, "device_ops": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
