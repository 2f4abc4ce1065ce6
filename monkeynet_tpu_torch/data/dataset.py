"""Frame datasets: one video per file.

Counterpart of `FramesDataset` in monkeynet_tpu/data/dataset.py, with the
reference's behaviour (frames_dataset.py:43-131): predefined train/test
subfolders or a random 80/20 split (sklearn's split with the reference's
seed, rebuilt here in numpy); train items go through the augmentation
pipeline, test items are returned whole. `PairedDataset` pairs videos for
transfer, from a CSV pairs list or by seeded random index pairs.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from monkeynet_tpu_torch.data.augmentation import AllAugmentationTransform, VideoToTensor
from monkeynet_tpu_torch.data.io import read_video


def train_test_split(items, seed: int, test_size: float = 0.2):
    """(train, test) as sklearn.model_selection.train_test_split(items,
    random_state=seed, test_size=test_size) splits them: a permutation from
    np.random.RandomState(seed), the first ceil(test_size * n) to test."""
    n = len(items)
    n_test = int(np.ceil(test_size * n))
    order = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in order[n_test:]], [items[i] for i in order[:n_test]]


class FramesDataset:
    def __init__(
        self,
        root_dir: str,
        augmentation_params: Optional[dict] = None,
        image_shape=(64, 64, 3),
        is_train: bool = True,
        random_seed: int = 0,
        pairs_list: Optional[str] = None,
        transform=None,
        cache_videos: bool = False,
    ):
        self.root_dir = root_dir
        self.image_shape = tuple(image_shape)
        self.pairs_list = pairs_list
        # Optional uint8 RAM cache: decode once, at ~H*W*3*T bytes a video.
        self.cache_videos = cache_videos
        self._cache: dict = {}

        images = sorted(os.listdir(root_dir))
        if os.path.exists(os.path.join(root_dir, "train")):
            assert os.path.exists(os.path.join(root_dir, "test"))
            train_images = sorted(os.listdir(os.path.join(root_dir, "train")))
            test_images = sorted(os.listdir(os.path.join(root_dir, "test")))
            self.root_dir = os.path.join(root_dir, "train" if is_train else "test")
        else:
            train_images, test_images = train_test_split(images, random_seed)
        self.images = train_images if is_train else test_images

        if transform is not None:
            self.transform = transform
        elif is_train:
            self.transform = AllAugmentationTransform(**(augmentation_params or {}))
        else:
            self.transform = VideoToTensor()

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        name = os.path.join(self.root_dir, self.images[idx])
        if self.cache_videos and idx in self._cache:
            # uint8 straight into the transform: the conversion to float
            # comes after frame selection (augmentation._to_float).
            video = self._cache[idx]
        else:
            video = read_video(name, image_shape=self.image_shape)
            if self.cache_videos:
                self._cache[idx] = (video * 255.0 + 0.5).astype(np.uint8)
                video = self._cache[idx]
        try:
            out = self.transform(video, rng=rng)
        except TypeError:
            out = self.transform(video)
        out["name"] = os.path.basename(name)
        return out


class PairedDataset:
    """(driving, source) pairs for transfer mode: the first
    `number_of_pairs` rows of the dataset's `pairs_list` CSV (columns
    'source' and 'driving') whose videos both exist, or else
    `number_of_pairs` distinct index pairs drawn from the
    min(number_of_pairs, len)^2 grid by np.random.RandomState(seed), as the
    JAX package draws them."""

    def __init__(self, initial_dataset: FramesDataset, number_of_pairs: int, seed: int = 0):
        self.initial_dataset = initial_dataset
        pairs_list = initial_dataset.pairs_list
        rng = np.random.RandomState(seed)

        if pairs_list is None:
            max_idx = min(number_of_pairs, len(initial_dataset))
            xy = np.mgrid[:max_idx, :max_idx].reshape(2, -1).T
            number_of_pairs = min(xy.shape[0], number_of_pairs)
            choice = rng.choice(xy.shape[0], number_of_pairs, replace=False)
            self.pairs = [tuple(p) for p in xy[choice]]
        else:
            name_to_index = {name: i for i, name in enumerate(initial_dataset.images)}
            with open(pairs_list, newline="") as f:
                rows = [row for row in csv.DictReader(f)
                        if row["source"] in name_to_index and row["driving"] in name_to_index]
            self.pairs = [(name_to_index[row["driving"]], name_to_index[row["source"]])
                          for row in rows[:number_of_pairs]]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        driving_idx, source_idx = self.pairs[idx]
        first = self.initial_dataset[driving_idx]
        second = self.initial_dataset[source_idx]
        out = {f"driving_{k}": v for k, v in first.items()}
        out.update({f"source_{k}": v for k, v in second.items()})
        return out
