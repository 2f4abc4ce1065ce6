"""Background removal for animation datasets (MGif-style preprocessing).

Counterpart of monkeynet_tpu/data/bg_removal.py, with the same behaviour:
the capability of the reference's sup-mat/MGif/bg_removal_tool.py (an
interactive OpenCV tool for whitening video backgrounds), scriptable.
GrabCut, seeded with the frame's border as probable background and the rest
as probable foreground, runs on each frame of a video; the pixels it leaves
as background turn white, and a frame GrabCut refuses is kept as it is.
Videos are read and written through data/io.py.

    python -m monkeynet_tpu_torch.data.bg_removal in.png out.png --image_shape 128
"""

from __future__ import annotations

import numpy as np


def remove_background_frame(frame_u8: np.ndarray, iterations: int = 3) -> np.ndarray:
    """frame (H, W, 3) uint8 -> same with background whitened."""
    import cv2

    h, w = frame_u8.shape[:2]
    mask = np.full((h, w), cv2.GC_PR_FGD, np.uint8)
    border = max(1, min(h, w) // 16)
    mask[:border, :] = cv2.GC_PR_BGD
    mask[-border:, :] = cv2.GC_PR_BGD
    mask[:, :border] = cv2.GC_PR_BGD
    mask[:, -border:] = cv2.GC_PR_BGD

    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(frame_u8, mask, None, bgd, fgd, iterations, cv2.GC_INIT_WITH_MASK)
    except cv2.error:
        return frame_u8
    is_bg = (mask == cv2.GC_BGD) | (mask == cv2.GC_PR_BGD)
    out = frame_u8.copy()
    out[is_bg] = 255
    return out


def remove_background_video(video: np.ndarray, iterations: int = 3) -> np.ndarray:
    """(T, H, W, 3) float32 [0,1] -> same with backgrounds whitened."""
    out = []
    for frame in video:
        u8 = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
        out.append(remove_background_frame(u8, iterations).astype(np.float32) / 255.0)
    return np.stack(out)


def main(argv=None) -> None:
    from argparse import ArgumentParser

    from monkeynet_tpu_torch.data.io import read_video, write_stacked_png

    parser = ArgumentParser(description=__doc__)
    parser.add_argument("input", help="stacked-frame image or gif/mp4")
    parser.add_argument("output", help="output stacked-frame png")
    parser.add_argument("--image_shape", type=int, default=128)
    parser.add_argument("--iterations", type=int, default=3)
    args = parser.parse_args(argv)

    video = read_video(args.input, (args.image_shape, args.image_shape, 3))
    cleaned = remove_background_video(video, args.iterations)
    write_stacked_png(args.output, cleaned)
    print(f"wrote {args.output} ({cleaned.shape[0]} frames)")


if __name__ == "__main__":
    main()
