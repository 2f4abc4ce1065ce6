#!/usr/bin/env python3
"""Write tests/fixtures/jax_train_checkpoint.msgpack with the JAX package.

    JAX_PLATFORMS=cpu python3 scripts/make_jax_checkpoint_fixture.py

The JAX package's own `train()` (monkeynet_tpu/tasks/train_loop.py) runs 2
steps at the tiny widths of tests/torch_port_common.py's `tiny_config`
(4 keypoints, 8 / 64 channels, 3 blocks) over the first 8 train videos of
data/shapes at 64^2: batch 4, one epoch of 2 steps on the device feed, the
rate dropping 10x after epoch 1 (so the file's Adam count, 2, sits past the
milestone). The exit checkpoint it writes, `00000000-checkpoint.msgpack`
(the train state: parameters, batch statistics and both networks' optax
chain states; epoch 0, it 1), is copied to tests/fixtures/ with the config
beside it as jax_train_checkpoint.yaml. The PyTorch port's tests and
chip_smoke.py read this file; the port has no JAX to write one.

A train checkpoint at configs/shapes.yaml's widths is 58.5 MB, too large to
commit. The script writes its layout instead, jax_shapes_train_layout.json:
the tree of the file the JAX package's `save_checkpoint` writes for a
`create_train_state` at those widths (the inits' shapes through
`jax.eval_shape`, no forward), each leaf as its shape and dtype name.
chip_smoke.py fills that layout with seeded values and writes it as flax
does, so the card resumes a file of that layout at full width. This script
is part of the JAX package's tooling: it imports JAX and the JAX package.
"""

from __future__ import annotations

import copy
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
NAME = "jax_train_checkpoint"
LAYOUT = "jax_shapes_train_layout.json"
VIDEOS = 8


def fixture_config() -> dict:
    from tests.torch_port_common import tiny_config

    config = copy.deepcopy(tiny_config())
    config["dataset_params"] = {
        "root_dir": "data/shapes",
        "image_shape": [64, 64, 3],
        "augmentation_params": {
            "flip_param": {"time_flip": True, "horizontal_flip": True},
            "crop_param": {"size": [64, 64]},
        },
    }
    config["train_params"].update(
        batch_size=4, num_epochs=1, epoch_milestones=[1], device_feed=True,
        log_params={"log_freq_iter": 1, "cpk_freq_epoch": 1},
    )
    config["reconstruction_params"] = {"num_videos": 1, "format": ".gif"}
    config["transfer_params"] = {
        "num_pairs": 2, "format": ".gif",
        "normalization_params": {"movement_mult": False, "move_location": True,
                                 "adapt_variance": False},
    }
    config["prediction_params"] = {
        "rnn_params": {"num_features": 32, "num_layers": 1, "dropout": 0},
        "predict_variance": True, "num_epochs": 2, "lr": 0.001, "batch_size": 4,
        "num_frames": 8, "init_frames": 1, "train_size": 3, "format": ".gif",
    }
    config["visualizer_params"] = {"kp_size": 2, "draw_border": True,
                                   "colormap": "gist_rainbow"}
    return config


def layout_of(tree):
    """{key: layout} down to each leaf's {'shape', 'dtype'}."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: layout_of(v) for k, v in tree.items()}
    leaf = np.asarray(tree)
    return {"shape": list(leaf.shape), "dtype": leaf.dtype.name}


def shapes_train_layout() -> dict:
    """The layout of the JAX package's train checkpoint of configs/shapes.yaml:
    zeros through `create_train_state` and `_make_payload`, written by its
    `save_checkpoint` and read back by flax."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import yaml

    from monkeynet_tpu.tasks import build, train as jtrain, train_loop
    from monkeynet_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    config = yaml.safe_load((REPO / "configs" / "shapes.yaml").read_text())
    generator, discriminator, kp_detector = build.build_models(config)
    k = config["model_params"]["common_params"]["num_kp"]
    frame = jnp.zeros((1, 1, 64, 64, 3))
    kp = {"mean": jnp.zeros((1, 1, k, 2)), "var": jnp.tile(jnp.eye(2) * 0.1, (1, 1, k, 1, 1))}
    key = jax.random.PRNGKey(0)
    shapes = {
        "generator": jax.eval_shape(lambda: generator.init(key, frame, kp, kp, False)),
        "discriminator": jax.eval_shape(lambda: discriminator.init(key, frame, kp, kp)),
        "kp_detector": jax.eval_shape(lambda: kp_detector.init(key, frame, False)),
    }
    zeros = lambda tree: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)  # noqa: E731
    tp = config["train_params"]
    state = jtrain.create_train_state(
        {n: zeros(v["params"]) for n, v in shapes.items()},
        {n: zeros(shapes[n]["batch_stats"]) for n in ("generator", "kp_detector")},
        jtrain.make_optimizer(jtrain.multistep_lr(tp["lr"], tp["epoch_milestones"], 1)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "00000000-checkpoint.msgpack")
        save_checkpoint(path, train_loop._make_payload(state, 0, 0)())
        return layout_of(load_checkpoint(path))


def main() -> int:
    sys.path.insert(0, str(REPO))
    import json

    import yaml

    from monkeynet_tpu.data.dataset import FramesDataset
    from monkeynet_tpu.tasks.train_loop import train

    config = fixture_config()
    run_config = copy.deepcopy(config)
    run_config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
    dataset = FramesDataset(is_train=True, **run_config["dataset_params"])
    dataset.images = dataset.images[:VIDEOS]
    with tempfile.TemporaryDirectory() as log_dir:
        train(run_config, log_dir, dataset, seed=0)
        written = sorted(p for p in os.listdir(log_dir) if p.endswith("-checkpoint.msgpack"))
        if written != ["00000000-checkpoint.msgpack"]:
            raise SystemExit(f"train() wrote {written}")
        FIXTURES.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(log_dir, written[0]), FIXTURES / f"{NAME}.msgpack")
    with open(FIXTURES / f"{NAME}.yaml", "w") as f:
        f.write("# The config tests/fixtures/jax_train_checkpoint.msgpack was trained with\n"
                "# (scripts/make_jax_checkpoint_fixture.py); root_dir is relative to the\n"
                "# repository.\n")
        yaml.safe_dump(config, f, sort_keys=False)
    size = (FIXTURES / f"{NAME}.msgpack").stat().st_size
    print(f"wrote {FIXTURES / NAME}.msgpack ({size} bytes) and its config")
    with open(FIXTURES / LAYOUT, "w") as f:
        json.dump(shapes_train_layout(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {FIXTURES / LAYOUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
