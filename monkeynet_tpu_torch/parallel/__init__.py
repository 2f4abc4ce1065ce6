"""Data parallelism: batch-sharded training over a process group, frame-sharded eval."""

from monkeynet_tpu_torch.parallel.mesh import (
    make_devices,
    make_sharded_train_step,
    shard_batch,
)

__all__ = ["make_devices", "make_sharded_train_step", "shard_batch"]
