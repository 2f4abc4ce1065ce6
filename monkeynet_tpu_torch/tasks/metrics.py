"""Reconstruction quality metrics: L1, AKD, AED.

Counterpart of monkeynet_tpu/tasks/metrics.py. The Monkey-Net paper
(arXiv:1812.08861) evaluates reconstruction with L1, AKD (average keypoint
distance) and AED (average euclidean distance in an identity-embedding
space); the external detectors and embedders it used are not
distributable, so both packages stand in their own:

- **AKD** with the model's own keypoint detector as the landmark model:
  keypoints of the ground-truth frames against those of the generated
  frames, in pixels.
- **AED** with a frozen embedding network by default: the generator's
  `Encoder` architecture at fixed random weights, never trained, so AED
  compares across checkpoints of one config. The weights are the JAX
  package's own, flax's draw at PRNGKey(0), which `utils/flax_init.py`
  repeats bit for bit in numpy: the port's AED is the JAX package's.
  `variables` (a state_dict) replaces them. `embedder="appearance"` embeds
  with the trained generator's own appearance encoder instead (a per-run
  signal: it moves with the model it evaluates).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from monkeynet_tpu_torch.models.blocks import Encoder
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.flax_init import encoder_variables
from monkeynet_tpu_torch.utils.weights import from_jax_variables


def kp_to_pixels(mean: np.ndarray, image_shape) -> np.ndarray:
    """Keypoint means from [-1, 1] (xy) to pixels: (kp + 1) / 2 * (size - 1),
    the exact inverse of the coordinate grid the keypoints were made on."""
    h, w = image_shape[0], image_shape[1]
    mean = np.asarray(mean)
    out = np.empty_like(mean)
    out[..., 0] = (mean[..., 0] + 1.0) / 2.0 * (w - 1)
    out[..., 1] = (mean[..., 1] + 1.0) / 2.0 * (h - 1)
    return out


def akd(kp_gt: Dict, kp_pred: Dict, image_shape) -> float:
    """Average keypoint distance in pixels: mean over frames and keypoints of
    the distance between ground-truth-frame and generated-frame keypoints."""
    gt = kp_to_pixels(kp_gt["mean"], image_shape)
    pred = kp_to_pixels(kp_pred["mean"], image_shape)
    return float(np.linalg.norm(gt - pred, axis=-1).mean())


class EmbeddingExtractor:
    """Frame embeddings: the deepest Encoder feature map averaged over space
    to one vector per frame.

    embedder="frozen" (default): an Encoder at `variables` (a state_dict),
    or at the JAX package's PRNGKey(0) weights when none are given.
    embedder="appearance": the trained generator's appearance encoder.
    """

    def __init__(self, config, generator=None, chunk: int = 128, embedder: str = "frozen",
                 variables: Optional[Dict[str, torch.Tensor]] = None, device="cuda"):
        self.device = require_device(device)
        if embedder == "appearance":
            if generator is None:
                raise ValueError("appearance embedder requires the generator")
            encoder = copy.deepcopy(generator.appearance_encoder)
        elif embedder == "frozen":
            gp = config["model_params"]["generator_params"]
            channels = tuple(config["dataset_params"].get("image_shape", (64, 64, 3)))[2]
            encoder = Encoder(gp["block_expansion"], channels, gp["num_blocks"],
                              gp["max_features"])
            if variables is None:
                variables = from_jax_variables(**encoder_variables(
                    gp["block_expansion"], channels, gp["num_blocks"], gp["max_features"]))
            encoder.load_state_dict(variables)
        else:
            raise ValueError(f"unknown AED embedder: {embedder!r}")
        self.embedder = embedder
        self.chunk = chunk
        self.encoder = encoder.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, video) -> np.ndarray:
        """video (B, D, H, W, C), numpy or a tensor -> embeddings (B, D, F)."""
        video = torch.as_tensor(video, device=self.device).float()
        outs = [self.encoder(video[:, s : s + self.chunk])[-1].mean(dim=(2, 3))
                for s in range(0, video.shape[1], self.chunk)]
        return torch.cat(outs, dim=1).cpu().numpy()


def aed(emb_gt: np.ndarray, emb_pred: np.ndarray) -> float:
    """Average euclidean distance between per-frame embeddings."""
    return float(np.linalg.norm(emb_gt - emb_pred, axis=-1).mean())
