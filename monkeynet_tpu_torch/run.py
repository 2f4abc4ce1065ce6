"""The port's command line: train, reconstruction, transfer and prediction on the card.

    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode train
    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode reconstruction \\
        --checkpoint "log/shapes <date>/00000007-checkpoint.pth.tar"
    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode transfer \\
        --checkpoint ...
    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode prediction \\
        --checkpoint ...
    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode reconstruction \\
        --checkpoint "log/shapes <date>/00000007-checkpoint.msgpack"

Counterpart of the repository's run.py (the JAX package's CLI): a
timestamped log directory (or the checkpoint's own) with the config copied
in, the config's dataset (its train split for train, its test split for
the rest), then the mode. Train resumes from `--checkpoint`; the eval modes
need one. Either package's checkpoint will do in every mode: a `.pth.tar`
the port wrote or one in the reference's form, or a `.msgpack` the JAX
package's train wrote (its parameters, batch statistics and Adam moments;
utils/checkpoint.py `load_any`). It runs on the card and refuses to start
without one.

`--num_devices N` trains data-parallel over N cards (N ranks, spawned here,
or this process one of N under torchrun) and shards the eval modes' frames
over N cards:

    python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --num_devices 4
    torchrun --nproc_per_node 4 -m monkeynet_tpu_torch.run --config configs/shapes.yaml \
        --num_devices 4
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
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint to resume from (train) or to evaluate: the "
                             "port's or the reference's .pth.tar, or the JAX package's "
                             ".msgpack")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="data-parallel mesh size: batch-sharded training, "
                             "frame-sharded eval (1 = single chip)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of train steps 10-20 into DIR")
    parser.add_argument("--verbose", action="store_true", help="print models")
    opt = parser.parse_args(argv)

    import torch.distributed as dist

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from monkeynet_tpu_torch.utils.config import load_config, prepare_log_dir
    from monkeynet_tpu_torch.utils.device import require_device

    device = require_device("cuda")
    config = load_config(opt.config)
    if opt.mode == "train" and maybe_initialize_distributed():
        # Under torchrun every rank trains into rank 0's directory.
        log_dir = [prepare_log_dir(opt.config, opt.log_dir, opt.checkpoint)
                   if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(log_dir, src=0)
        log_dir = log_dir[0]
    else:
        log_dir = prepare_log_dir(opt.config, opt.log_dir, opt.checkpoint)

    if opt.verbose:
        from monkeynet_tpu_torch.tasks.build import build_train_models

        for model in build_train_models(config, device=device).values():
            print(model)

    dataset = FramesDataset(is_train=(opt.mode == "train"), **config["dataset_params"])
    if opt.mode == "train":
        print("Training...")
        from monkeynet_tpu_torch.tasks.train_loop import train

        run = train(config, log_dir, dataset, checkpoint=opt.checkpoint, seed=opt.seed,
                    num_devices=opt.num_devices, profile_dir=opt.profile, device=device)
        print(f"{run.steps} steps in {run.wall_s:.3f} s, {run.loader_wait_s:.3f} s of it "
              f"waiting on the loader; log and checkpoints in {log_dir}")
    elif opt.mode == "reconstruction":
        print("Reconstruction...")
        from monkeynet_tpu_torch.tasks.reconstruction import reconstruction

        reconstruction(config, log_dir, dataset, opt.checkpoint, device=device,
                       num_devices=opt.num_devices)
    elif opt.mode == "transfer":
        print("Transfer...")
        from monkeynet_tpu_torch.tasks.transfer import transfer

        transfer(config, log_dir, dataset, opt.checkpoint, device=device,
                 num_devices=opt.num_devices)
    else:
        print("Prediction...")
        from monkeynet_tpu_torch.tasks.prediction import prediction

        # prediction reads the config's train and test splits itself
        out = prediction(config, log_dir, opt.checkpoint, seed=opt.seed, device=device,
                         num_devices=opt.num_devices)
        print(f"predictor loss {out['losses'][0]:.5f} in epoch 0, {out['losses'][-1]:.5f} in "
              f"epoch {len(out['losses']) - 1}; {out['videos']} test videos rendered")
    return 0


if __name__ == "__main__":
    sys.exit(main())
