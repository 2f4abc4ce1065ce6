"""Image-to-video prediction: learn keypoint dynamics, render the future.

Counterpart of monkeynet_tpu/tasks/prediction.py, with the reference
driver's three phases (prediction.py:35-145):
  1. the keypoints of every frame of the first `train_size` + 1 train videos
     (the reference's bound), by the kp detector over frame chunks;
  2. the GRU keypoint predictor trained on fixed-length windows: inputs
     zeroed after `init_frames`, L1 on every keypoint field, Adam with the
     rate set each epoch by a reduce-on-plateau rule;
  3. on every test video: keypoints of its first `num_frames` frames, all
     but the first `init_frames` zeroed, the predictor's trajectory, and
     the generator's rendering of it.
The GRU takes the zeroed window in one forward (the reference's scheme; it
is not autoregressive).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

from monkeynet_tpu_torch.data.augmentation import VideoToTensor
from monkeynet_tpu_torch.data.dataset import FramesDataset
from monkeynet_tpu_torch.data.io import write_gif, write_stacked_png
from monkeynet_tpu_torch.data.loader import DataLoader
from monkeynet_tpu_torch.models.prediction import KeypointPredictor
from monkeynet_tpu_torch.parallel.mesh import local_devices
from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor
from monkeynet_tpu_torch.tasks.reconstruction import load_eval_models, to_numpy
from monkeynet_tpu_torch.utils.async_write import AsyncWriter
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.visualizer import Visualizer


class KPSequenceDataset:
    """Consecutive fixed-length keypoint windows from per-video kp arrays
    (reference KPDataset, prediction.py:18-32); the window's start is drawn
    from the item's RNG."""

    def __init__(self, keypoints: List[Dict[str, np.ndarray]], num_frames: int):
        self.keypoints = keypoints
        self.num_frames = num_frames

    def __len__(self):
        return len(self.keypoints)

    def __getitem__(self, idx, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        kp = self.keypoints[idx]
        total = kp["mean"].shape[0]
        k = self.num_frames
        first = int(rng.integers(0, max(1, total - k + 1)))
        out = {key: v[first : first + k] for key, v in kp.items()}
        # pad short videos by repeating the last frame
        cur = out["mean"].shape[0]
        if cur < k:
            out = {key: np.concatenate([v] + [v[-1:]] * (k - cur), axis=0)
                   for key, v in out.items()}
        return out


class ReduceLROnPlateau:
    """The JAX package's plateau rule: the rate falls by `factor` once the
    loss has failed to beat best * (1 - threshold) on more than `patience`
    epochs in a row. (torch.optim.lr_scheduler.ReduceLROnPlateau counts its
    threshold and its bad epochs otherwise.)"""

    def __init__(self, lr: float, patience: int = 50, factor: float = 0.1,
                 threshold: float = 1e-4):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, loss: float) -> float:
        if loss < self.best * (1.0 - self.threshold):
            self.best = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


@dataclasses.dataclass
class PredictorRun:
    """What `train_predictor` returns: the trained predictor, each epoch's
    mean loss and the rate each epoch ran at."""

    predictor: KeypointPredictor
    losses: List[float]
    lrs: List[float]


def _window_loss(predictor, batch, init_frames: int):
    """L1 between the window and the prediction from its first `init_frames`
    frames, summed over the keypoint fields, on the frames after them."""
    x = {k: torch.cat([v[:, :init_frames], torch.zeros_like(v[:, init_frames:])], dim=1)
         for k, v in batch.items()}
    pred = predictor(x)
    return sum((batch[k][:, init_frames:] - pred[k][:, init_frames:]).abs().mean()
               for k in batch)


def train_predictor(predictor: KeypointPredictor, kp_windows: KPSequenceDataset,
                    prediction_params, seed: int = 0, device="cuda") -> PredictorRun:
    """Phase 2: fit `predictor` (already initialised) on windows whose frames
    after `init_frames` are zeroed. Adam (0.9, 0.999, eps 1e-8, as optax's
    scale_by_adam) at the plateau's rate, which is set once an epoch; the
    windows in order, the last partial batch kept."""
    device = require_device(device)
    init_frames = prediction_params["init_frames"]
    predictor = predictor.to(device)
    # The JAX package applies the predictor without train=True, so dropout
    # between stacked layers stays off while it trains: eval mode here. cuDNN
    # takes an RNN's backward only in training mode, so the GRU runs on
    # PyTorch's own CUDA GRU cells instead (train_predictor below).
    predictor.eval()
    plateau = ReduceLROnPlateau(prediction_params["lr"])
    optimizer = torch.optim.Adam(predictor.parameters(), lr=plateau.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    loader = DataLoader(kp_windows, batch_size=min(prediction_params["batch_size"],
                                                   len(kp_windows)),
                        shuffle=False, drop_last=False, num_workers=2, seed=seed)
    losses, lrs = [], []
    for _ in range(prediction_params["num_epochs"]):
        lr = plateau.lr
        for group in optimizer.param_groups:
            group["lr"] = lr
        epoch_losses = []
        for batch in loader:
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            with torch.backends.cudnn.flags(enabled=False):
                loss = _window_loss(predictor, batch, init_frames)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            optimizer.step()
            epoch_losses.append(loss.detach())
        # the mean in float64 of the batches' losses, as np.mean of floats
        losses.append(float(np.mean(torch.stack(epoch_losses).double().cpu().numpy())))
        lrs.append(lr)
        plateau.step(losses[-1])
    return PredictorRun(predictor, losses, lrs)


def build_predictor(config, seed: int = 0) -> KeypointPredictor:
    """The config's predictor, initialised from a torch.Generator at `seed`."""
    common = config["model_params"]["common_params"]
    predictor = KeypointPredictor(num_kp=common["num_kp"], kp_variance=common["kp_variance"],
                                  **config["prediction_params"]["rnn_params"])
    return predictor.reset_parameters(torch.Generator().manual_seed(seed))


@torch.no_grad()
def predict_keypoints(predictor, kp_init: Dict[str, np.ndarray], prediction_params,
                      device) -> Dict[str, np.ndarray]:
    """Phase 3's trajectory: the predictor's keypoints from `kp_init` (frames
    after `init_frames` zeroed), its first `init_frames` frames put back,
    and with `predict_variance` the covariance of the last initial frame
    held over every frame."""
    init_frames = prediction_params["init_frames"]
    kp_video = predictor({k: torch.as_tensor(v, device=device) for k, v in kp_init.items()})
    kp_video = to_numpy(kp_video)
    for k in kp_video:
        kp_video[k][:, :init_frames] = kp_init[k][:, :init_frames]
    if "var" in kp_video and prediction_params["predict_variance"]:
        kp_video["var"] = np.repeat(kp_init["var"][:, init_frames - 1 : init_frames],
                                    kp_video["var"].shape[1], axis=1)
    return kp_video


def prediction(config, log_dir, checkpoint, device="cuda", seed: int = 0,
               num_devices: int = 1) -> Dict:
    """The three phases into `log_dir`/prediction; return {'losses', 'lrs',
    'videos'}: the predictor's loss and rate per epoch and the number of
    test videos rendered. `num_devices` > 1 shards the keypoint extraction
    and the animation over that many devices; the GRU stays on the first."""
    if checkpoint is None:
        raise ValueError("checkpoint is required for prediction mode")
    device = require_device(device)
    log_dir = os.path.join(log_dir, "prediction")
    png_dir = os.path.join(log_dir, "png")
    os.makedirs(png_dir, exist_ok=True)

    prediction_params = config["prediction_params"]
    num_frames = prediction_params["num_frames"]
    init_frames = prediction_params["init_frames"]
    train_size = prediction_params["train_size"]

    devices = local_devices(num_devices, device)
    generator, kp_detector = load_eval_models(config, checkpoint, device)
    animate = Animator(generator, devices=devices)
    extract_kp = KPExtractor(kp_detector, devices=devices)
    visualizer = Visualizer(**(config.get("visualizer_params") or {}))

    # ---- phase 1: keypoints over the train set
    print("Extracting keypoints...")
    train_set = FramesDataset(is_train=True, transform=VideoToTensor(),
                              **config["dataset_params"])
    keypoints = []
    for it in range(len(train_set)):
        if train_size is not None and it > train_size:
            break
        kp = extract_kp(train_set[it]["video"][None])
        keypoints.append({k: v[0] for k, v in kp.items()})

    # ---- phase 2: the GRU on keypoint windows
    print("Training prediction...")
    windows = KPSequenceDataset(keypoints, num_frames=num_frames)
    run = train_predictor(build_predictor(config, seed), windows, prediction_params,
                          seed=seed, device=device)

    # ---- phase 3: roll out and render on the test set
    print("Make predictions...")
    test_set = FramesDataset(is_train=False, transform=VideoToTensor(),
                             **config["dataset_params"])
    fmt = prediction_params.get("format", ".gif")
    with AsyncWriter(name="monkeynet-prediction-vis") as writer:
        for it in range(len(test_set)):
            x = test_set[it]
            video = x["video"][None, :num_frames]
            kp_init = extract_kp(video)
            for k in kp_init:
                kp_init[k][:, init_frames:] = 0
            kp_source = {k: v[:, :1] for k, v in extract_kp(video[:, :1]).items()}
            kp_video = predict_keypoints(run.predictor, kp_init, prediction_params, device)

            out = to_numpy(animate(video[:, :1], kp_video, kp_source))
            out["kp_driving"] = kp_video
            out["kp_source"] = kp_source

            def job(name=x["name"], video=video, out=out):
                write_stacked_png(os.path.join(png_dir, name + ".png"),
                                  out["video_prediction"][0])
                grid = visualizer.visualize_reconstruction(
                    {"source": video[:, :1], "video": video}, out)
                write_gif(os.path.join(log_dir, name + fmt), grid)

            writer.submit(job)
    return {"losses": run.losses, "lrs": run.lrs, "videos": len(test_set)}
