"""Dataset preparation tools.

Counterpart of monkeynet_tpu/data/tools.py, with the same behaviour and the
reference's data helpers' capabilities:
  - split_train_test: a 90/10 split of a folder's files into train/ and
    test/ (reference data/split.py), the same lists as sklearn's
    train_test_split gives for the seed (the port's copy of it,
    data/dataset.py);
  - preprocess_frames_dir: a directory of per-video frame folders -> one
    stacked-frame JPG/PNG per video, resized square (reference
    data/preprocess_vox.py, which flattens VoxCeleb frame dirs to 256^2
    stacked JPGs and warns on >100-frame videos);
  - preprocess_vox: VoxCeleb1 frame folders -> train/ and test/ stacked
    images, partitioned by the repository's data/{train,test}_vox1.txt.
Images are read and written through data/io.py (Pillow) and resized with
OpenCV: no sklearn or imageio.

    python -m monkeynet_tpu_torch.data.tools split <dir> [--test_size 0.1]
    python -m monkeynet_tpu_torch.data.tools preprocess <in_dir> <out_dir> [--size 256]
    python -m monkeynet_tpu_torch.data.tools vox <in_dir> <out_dir> [--lists_dir data]
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from monkeynet_tpu_torch.data.dataset import train_test_split
from monkeynet_tpu_torch.data.io import read_image, write_image


def split_train_test(root_dir: str, test_size: float = 0.1, seed: int = 0) -> None:
    """Move the files in root_dir into train/ and test/ subfolders."""
    files = sorted(
        f
        for f in os.listdir(root_dir)
        if os.path.isfile(os.path.join(root_dir, f))
    )
    if not files:
        raise ValueError(f"no files to split in {root_dir}")
    if len(files) - int(np.ceil(test_size * len(files))) <= 0:
        raise ValueError(f"{len(files)} files at test_size {test_size} leave the train "
                         "set empty")
    train, test = train_test_split(files, seed, test_size=test_size)
    for split, names in (("train", train), ("test", test)):
        os.makedirs(os.path.join(root_dir, split), exist_ok=True)
        for name in names:
            shutil.move(
                os.path.join(root_dir, name), os.path.join(root_dir, split, name)
            )


def _stacked(frame_dir: str, frames, size: int) -> np.ndarray:
    """The frames of one folder, each resized to size^2 (area
    interpolation), side by side."""
    import cv2

    return np.concatenate(
        [cv2.resize(read_image(os.path.join(frame_dir, frame)), (size, size),
                    interpolation=cv2.INTER_AREA) for frame in frames],
        axis=1,
    )


def preprocess_frames_dir(
    in_dir: str, out_dir: str, size: int = 256, fmt: str = "jpg",
    max_frames_warn: int = 100,
) -> None:
    """Each subfolder of in_dir holds one video's frames; write one stacked-
    frame image per video to out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    for video in sorted(os.listdir(in_dir)):
        vdir = os.path.join(in_dir, video)
        if not os.path.isdir(vdir):
            continue
        frames = sorted(os.listdir(vdir))
        if len(frames) > max_frames_warn:
            print(f"WARNING: {video} has {len(frames)} frames")
        write_image(os.path.join(out_dir, f"{video}.{fmt}"), _stacked(vdir, frames, size))


_REPO_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data",
)


def preprocess_vox(
    in_dir: str,
    out_dir: str,
    lists_dir: str = _REPO_DATA,
    size: int = 256,
    fmt: str = "jpg",
) -> None:
    """VoxCeleb1 frame dirs -> per-partition stacked-frame images.

    Reference flow (data/preprocess_vox.py + data/{train,test}_vox1.txt):
    identities are partitioned by the bundled lists; each
    <in_dir>/<celeb>/1.6/<video>/<part>/ frame folder becomes one
    <partition>/<celeb>-<video>-<part>.jpg stacked 256^2 image, warning on
    sequences longer than 100 or shorter than 4 frames.
    """
    for partition in ("train", "test"):
        par_dir = os.path.join(out_dir, partition)
        os.makedirs(par_dir, exist_ok=True)
        with open(os.path.join(lists_dir, f"{partition}_vox1.txt")) as f:
            celebs = f.read().splitlines()
        for celeb in celebs:
            celeb_dir = os.path.join(in_dir, celeb, "1.6")
            if not os.path.isdir(celeb_dir):
                continue
            for video in sorted(os.listdir(celeb_dir)):
                video_dir = os.path.join(celeb_dir, video)
                for part in sorted(os.listdir(video_dir)):
                    part_dir = os.path.join(video_dir, part)
                    frames = sorted(os.listdir(part_dir))
                    if len(frames) > 100 or len(frames) < 4:
                        print(f"Warning sequence of len - {len(frames)}")
                    write_image(os.path.join(par_dir, f"{celeb}-{video}-{part}.{fmt}"),
                                _stacked(part_dir, frames, size))


def main(argv=None) -> None:
    from argparse import ArgumentParser

    parser = ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("split")
    s.add_argument("root_dir")
    s.add_argument("--test_size", type=float, default=0.1)
    s.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("preprocess")
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--format", default="jpg")
    v = sub.add_parser("vox")
    v.add_argument("in_dir", help="unzippedIntervalFaces/data directory")
    v.add_argument("out_dir")
    v.add_argument("--lists_dir", default=_REPO_DATA)
    v.add_argument("--size", type=int, default=256)
    v.add_argument("--format", default="jpg")
    args = parser.parse_args(argv)
    if args.cmd == "split":
        split_train_test(args.root_dir, args.test_size, args.seed)
    elif args.cmd == "vox":
        preprocess_vox(args.in_dir, args.out_dir, args.lists_dir, args.size, args.format)
    else:
        preprocess_frames_dir(args.in_dir, args.out_dir, args.size, args.format)


if __name__ == "__main__":
    main()
