"""GRU keypoint-trajectory predictor (image-to-video mode).

Counterpart of monkeynet_tpu/models/prediction.py, with the reference
PredictionModule's semantics (modules/prediction_module.py:5-44): the
keypoint state of each frame flattened (the means, then the covariances)
-> a stacked GRU -> a linear head; the head's output per keypoint is split
into a mean, through tanh, and a 2x2 factor v whose v^T v is the
covariance. The JAX package scans a GRU with torch's gate equations and
parameter layout, so `torch.nn.GRU` is the same layer here; there is no
hand-written kernel for it, as there is no Pallas kernel for it.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch
from torch import nn


def _var_size(kp_variance: Union[str, float]) -> int:
    """Entries of one keypoint's covariance in the keypoint state."""
    return {"matrix": 4, "single": 1}.get(kp_variance, 0) if isinstance(kp_variance, str) else 0


class KeypointPredictor(nn.Module):
    """{'mean': (B, D, K, 2)[, 'var': (B, D, K, 2, 2)]} -> the same keys.
    The covariance is in the state when `kp_variance` is 'matrix' (or
    'single'), as the keypoint detector makes it."""

    def __init__(self, num_kp: int = 10, kp_variance: Union[str, float] = 0.01,
                 num_features: int = 1024, num_layers: int = 1, dropout: float = 0.5):
        super().__init__()
        self.num_kp = num_kp
        self.num_features = num_features
        in_features = num_kp * (2 + _var_size(kp_variance))
        # dropout between stacked layers, in training mode only, as the
        # JAX package's nn.Dropout(deterministic=not train)
        self.gru = nn.GRU(in_features, num_features, num_layers=num_layers,
                          dropout=dropout if num_layers > 1 else 0.0, batch_first=True)
        self.head = nn.Linear(num_features, in_features)

    def reset_parameters(self, generator: torch.Generator) -> "KeypointPredictor":
        """Every weight and bias uniform in +-1/sqrt(num_features), as both
        torch's GRU and the JAX package initialise them, drawn from
        `generator` in module order."""
        bound = 1.0 / math.sqrt(self.num_features)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)
        return self

    def forward(self, kp_batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        B, D, K, _ = kp_batch["mean"].shape
        inputs = [kp_batch["mean"].reshape(B, D, -1)]
        has_var = "var" in kp_batch
        if has_var:
            inputs.append(kp_batch["var"].reshape(B, D, -1))
        x, _ = self.gru(torch.cat(inputs, dim=-1))
        x = self.head(x).reshape(B, D, K, -1)
        out = {"mean": torch.tanh(x[..., :2])}
        if has_var:
            v = x[..., 2:].reshape(B, D, K, 2, 2)
            out["var"] = v.transpose(-1, -2) @ v
        return out
