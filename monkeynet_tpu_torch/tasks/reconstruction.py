"""Reconstruction (self-reenactment) evaluation.

Counterpart of monkeynet_tpu/tasks/reconstruction.py, with the reference
driver's behaviour (reconstruction.py:28-77): frame 0 of each test video is
the source, the keypoints of every frame drive the generator, the outputs
are written as a stacked PNG and a comparison-grid gif, and the mean
per-frame L1 against the ground truth is printed, with AKD and AED
(tasks/metrics.py). Keypoint detection and generation run per frame chunk
in a `TransferEngine` with the identity normalisation; the gifs are encoded
on a writer thread while the next video runs on the card.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from monkeynet_tpu_torch.data.io import write_gif, write_stacked_png
from monkeynet_tpu_torch.parallel.mesh import local_devices
from monkeynet_tpu_torch.tasks.animate import KPExtractor, TransferEngine
from monkeynet_tpu_torch.tasks.build import build_models
from monkeynet_tpu_torch.tasks.metrics import EmbeddingExtractor, aed, akd
from monkeynet_tpu_torch.utils.async_write import AsyncWriter
from monkeynet_tpu_torch.utils.checkpoint import load_any
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.visualizer import Visualizer


def load_eval_models(config, checkpoint: str, device="cuda"):
    """(generator, kp_detector) in eval mode on `device`, with the weights of
    a checkpoint in either package's form (utils/checkpoint.py `load_any`):
    a `.pth.tar` (the train loop's checkpoint, or a file that holds only the
    'generator' and 'kp_detector' state_dicts, the reference's form), or
    the JAX package's `.msgpack` (its train state's two networks, as the
    JAX package's `load_eval_models` takes them, or a file of bare
    networks)."""
    generator, kp_detector = build_models(config, device=device)
    loaded = load_any(checkpoint)
    generator.load_state_dict(loaded["generator"])
    kp_detector.load_state_dict(loaded["kp_detector"])
    return generator, kp_detector


def to_numpy(out: Dict) -> Dict:
    """A dict of tensors and dicts of tensors, as numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in out.items()}


def reconstruction(config, log_dir, dataset, checkpoint, device="cuda",
                   aed_variables: Optional[Dict[str, torch.Tensor]] = None,
                   num_devices: int = 1) -> Dict[str, float]:
    """Reconstruct the first `reconstruction_params.num_videos` + 1 videos of
    `dataset` (the reference's bound) into `log_dir`/reconstruction; return
    {'l1', 'akd', 'aed'}. `aed_variables`: the frozen embedder's weights
    (tasks/metrics.py). `num_devices` > 1 shards each chunk's frames over
    that many devices (parallel/mesh.py `local_devices`); the embedder
    stays on the first."""
    if checkpoint is None:
        raise ValueError("checkpoint is required for reconstruction mode")
    device = require_device(device)
    log_dir = os.path.join(log_dir, "reconstruction")
    png_dir = os.path.join(log_dir, "png")
    os.makedirs(png_dir, exist_ok=True)

    image_shape = tuple(config["dataset_params"].get("image_shape", (64, 64, 3)))
    devices = local_devices(num_devices, device)
    generator, kp_detector = load_eval_models(config, checkpoint, device)
    # Self-reenactment is transfer with the identity normalisation.
    engine = TransferEngine(generator, kp_detector, move_location=False, devices=devices)
    visualizer = Visualizer(**(config.get("visualizer_params") or {}))
    kp_extractor = KPExtractor(kp_detector, devices=devices)
    embedder = EmbeddingExtractor(
        config, generator,
        embedder=config["reconstruction_params"].get("aed_embedder", "frozen"),
        variables=aed_variables, device=device)

    num_videos = config["reconstruction_params"]["num_videos"]
    fmt = config["reconstruction_params"].get("format", ".gif")

    loss_list, akd_list, aed_list = [], [], []
    with AsyncWriter(name="monkeynet-recon-vis") as writer:
        for it in range(len(dataset)):
            # the reference stops after the video at index num_videos
            if num_videos is not None and it > num_videos:
                break
            x = dataset[it]
            video = x["video"][None]  # (1, D, H, W, C)
            source = video[:, :1]

            dev_out = engine(source, video)
            out = to_numpy({k: dev_out[k] for k in
                            ("video_prediction", "video_deformed", "kp_driving", "kp_source")})

            def job(name=x["name"], source=source, video=video, out=out):
                write_stacked_png(os.path.join(png_dir, name + ".png"),
                                  out["video_prediction"][0])
                grid = visualizer.visualize_reconstruction({"source": source, "video": video},
                                                           out)
                write_gif(os.path.join(log_dir, name + fmt), grid)

            writer.submit(job)

            loss_list.append(float(np.abs(out["video_prediction"] - video).mean()))
            # kp_driving is the keypoints of the ground-truth frames; the
            # generated frames stay on the card for their own.
            kp_pred = kp_extractor(dev_out["video_prediction"])
            akd_list.append(akd(out["kp_driving"], kp_pred, image_shape))
            aed_list.append(aed(embedder(video), embedder(dev_out["video_prediction"])))

    metrics = {
        "l1": float(np.mean(loss_list)),
        "akd": float(np.mean(akd_list)),
        "aed": float(np.mean(aed_list)),
    }
    print("Reconstruction loss: %s" % metrics["l1"])
    print("AKD (self-detector, px): %s" % metrics["akd"])
    print("AED (%s-embedder proxy): %s" % (embedder.embedder, metrics["aed"]))
    return metrics
