"""Motion transfer: animate a source identity with a driving video's motion.

Counterpart of monkeynet_tpu/tasks/transfer.py, with the reference
driver's behaviour (transfer.py:31-123): keypoint normalisation (relative
movement, convex-hull scale adaptation, mean clipping, covariance
adaptation re-made symmetric positive definite through an
eigendecomposition), a sweep over a `PairedDataset`, stacked PNG and
comparison-grid gif outputs.

The normalisation is host numpy and scipy on float32 arrays, as in the JAX
package (`np.linalg.eig`, whose real eigenvalues and order
`torch.linalg.eig` does not give). A recipe that is tensor math only
(move_location / clip_mean) runs whole per chunk in a `TransferEngine`;
the others run the kp detector (`KPExtractor`), normalise on the host and
generate with an `Animator`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from monkeynet_tpu_torch.data.dataset import PairedDataset
from monkeynet_tpu_torch.data.io import write_gif, write_stacked_png
from monkeynet_tpu_torch.parallel.mesh import local_devices
from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor, TransferEngine
from monkeynet_tpu_torch.tasks.reconstruction import load_eval_models, to_numpy
from monkeynet_tpu_torch.utils.async_write import AsyncWriter
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.visualizer import Visualizer


def make_symmetric_psd(mats: np.ndarray) -> np.ndarray:
    """Symmetrise and clamp eigenvalues to > 0 (reference transfer.py:17-28)."""
    sym = (mats + np.swapaxes(mats, -1, -2)) / 2
    d, u = np.linalg.eig(sym)
    d = np.where(d <= 0, 1e-6, d)
    d_matrix = np.zeros_like(mats)
    d_matrix[..., 0, 0] = d[..., 0]
    d_matrix[..., 1, 1] = d[..., 1]
    return (u @ d_matrix @ np.swapaxes(u, -1, -2)).astype(mats.dtype)


def normalize_kp(
    kp_video: Dict[str, np.ndarray],
    kp_appearance: Dict[str, np.ndarray],
    movement_mult: bool = False,
    move_location: bool = False,
    adapt_variance: bool = False,
    clip_mean: bool = False,
) -> Dict[str, np.ndarray]:
    """Adapt driving keypoints to the source identity (reference
    transfer.py:31-62). Inputs and outputs numpy; kp mean (1, D, K, 2)."""
    if movement_mult:
        from scipy.spatial import ConvexHull

        appearance_area = ConvexHull(kp_appearance["mean"][0, 0]).volume
        video_area = ConvexHull(kp_video["mean"][0, 0]).volume
        mult = np.sqrt(appearance_area) / np.sqrt(video_area)
    else:
        mult = 1.0

    kp_video = {k: np.array(v) for k, v in kp_video.items()}

    if move_location:
        diff = (kp_video["mean"] - kp_video["mean"][:, 0:1]) * mult
        kp_video["mean"] = diff + kp_appearance["mean"]

    if clip_mean:
        kp_video["mean"] = np.clip(kp_video["mean"], -1.0, 1.0)

    if "var" in kp_video and adapt_variance:
        # var_t <- var_t * var_0^{-1} * var_appearance, then made symmetric PSD
        inv_first = np.linalg.inv(kp_video["var"][:, 0:1])
        var = kp_video["var"] @ inv_first @ kp_appearance["var"]
        kp_video["var"] = make_symmetric_psd(var)

    return kp_video


def transfer_one(animate: Animator, extract_kp: KPExtractor, source_image, driving_video,
                 transfer_params) -> Dict:
    """source_image (1,1,H,W,C), driving_video (1,D,H,W,C) numpy -> numpy
    {'video_prediction', 'video_deformed', 'kp_driving', 'kp_source',
    'kp_norm'}."""
    kp_driving = extract_kp(driving_video)
    kp_source = extract_kp(source_image)
    kp_norm = normalize_kp(kp_driving, kp_source, **transfer_params["normalization_params"])
    out = to_numpy(animate(source_image, kp_norm, kp_source))
    out["kp_driving"] = kp_driving
    out["kp_source"] = kp_source
    out["kp_norm"] = kp_norm
    return out


def transfer(config, log_dir, dataset, checkpoint, device="cuda", num_devices: int = 1) -> int:
    """Animate `transfer_params.num_pairs` pairs of `dataset` into
    `log_dir`/transfer; return the number of pairs written. `num_devices`
    > 1 shards each chunk's frames over that many devices."""
    if checkpoint is None:
        raise ValueError("checkpoint is required for transfer mode")
    device = require_device(device)
    log_dir = os.path.join(log_dir, "transfer")
    png_dir = os.path.join(log_dir, "png")
    os.makedirs(png_dir, exist_ok=True)

    transfer_params = config["transfer_params"]
    pairs = PairedDataset(dataset, transfer_params["num_pairs"])
    devices = local_devices(num_devices, device)
    generator, kp_detector = load_eval_models(config, checkpoint, device)
    visualizer = Visualizer(**(config.get("visualizer_params") or {}))
    fmt = transfer_params.get("format", ".gif")

    norm = dict(transfer_params["normalization_params"])
    device_norm_ok = not norm.get("movement_mult", False) and not norm.get(
        "adapt_variance", False)
    if device_norm_ok:
        engine = TransferEngine(generator, kp_detector,
                                move_location=norm.get("move_location", False),
                                clip_mean=norm.get("clip_mean", False), devices=devices)
    else:
        animate = Animator(generator, devices=devices)
        extract_kp = KPExtractor(kp_detector, devices=devices)

    with AsyncWriter(name="monkeynet-transfer-vis") as writer:
        for it in range(len(pairs)):
            x = pairs[it]
            driving_video = x["driving_video"][None]
            source_image = x["source_video"][None, :1]
            if device_norm_ok:
                out = to_numpy(engine(source_image, driving_video))
            else:
                out = transfer_one(animate, extract_kp, source_image, driving_video,
                                   transfer_params)
            name = "-".join([x["driving_name"], x["source_name"]])

            def job(name=name, out=out, driving_video=driving_video,
                    source_image=source_image):
                write_stacked_png(os.path.join(png_dir, name + ".png"),
                                  out["video_prediction"][0])
                grid = visualizer.visualize_transfer(driving_video, source_image, out)
                write_gif(os.path.join(log_dir, name + fmt), grid)

            writer.submit(job)
    return len(pairs)
