"""The port's command line: train on the card.

    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode train
    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode train \\
        --checkpoint "log/shapes <date>/00000003-checkpoint.pth.tar"

Counterpart of the repository's run.py (the JAX package's CLI) for
`--mode train`: a timestamped log directory (or the checkpoint's own when
resuming) with the config copied in, then `train` on the config's dataset.
Reconstruction, transfer and prediction are not ported yet (ROADMAP item 6)
and exit with an error. It runs on the card and refuses to start without one.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser


def main(argv=None) -> int:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="path to config yaml")
    parser.add_argument("--mode", default="train",
                        choices=["train", "reconstruction", "transfer", "prediction"])
    parser.add_argument("--log_dir", default="log", help="root log directory")
    parser.add_argument("--checkpoint", default=None, help="checkpoint to resume from")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of train steps 10-20 into DIR")
    opt = parser.parse_args(argv)

    if opt.mode != "train":
        print(f"--mode {opt.mode} is not ported to monkeynet_tpu_torch yet (ROADMAP item 6); "
              "run.py runs it on the JAX package", file=sys.stderr)
        return 2

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.tasks.train_loop import train
    from monkeynet_tpu_torch.utils.config import load_config, prepare_log_dir
    from monkeynet_tpu_torch.utils.device import require_device

    device = require_device("cuda")
    config = load_config(opt.config)
    log_dir = prepare_log_dir(opt.config, opt.log_dir, opt.checkpoint)
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    print("Training...")
    run = train(config, log_dir, dataset, checkpoint=opt.checkpoint, seed=opt.seed,
                profile_dir=opt.profile, device=device)
    print(f"{run.steps} steps in {run.wall_s:.3f} s, {run.loader_wait_s:.3f} s of it "
          f"waiting on the loader; log and checkpoints in {log_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
