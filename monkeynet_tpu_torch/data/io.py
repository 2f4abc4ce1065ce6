"""Video decode: stacked-frame images and gif/mp4/mov containers.

Counterpart of monkeynet_tpu/data/io.py, with the same formats as the
reference reader (frames_dataset.py:14-40): a "video" is either (a) a single
PNG/JPG whose width is T x frame-width, frames stacked horizontally, or (b)
a gif/mp4/mov container. Grayscale is expanded to RGB, alpha dropped, output
float32 in [0, 1], shape (T, H, W, C).

The JAX package decodes with imageio where its native decoder is not built;
the port decodes with Pillow (which imageio itself uses for these images)
and OpenCV for mp4/mov, so it needs no imageio.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return _pil_array(im)


def _pil_array(im) -> np.ndarray:
    """A Pillow image as an array; a palette image is expanded to RGBA where
    it has transparency and to RGB otherwise, as imageio expands it (a gray
    palette, which imageio makes 2-D, gives the same RGB after
    `_ensure_rgb`)."""
    if im.mode == "P":
        im = im.convert("RGBA" if im.info.get("transparency") is not None else "RGB")
    return np.asarray(im)


def _read_frames(path: str) -> list:
    """Every frame of a gif (Pillow) or an mp4/mov (OpenCV), as arrays."""
    if path.lower().endswith(".gif"):
        from PIL import Image, ImageSequence

        with Image.open(path) as im:
            return [_pil_array(frame.copy()) for frame in ImageSequence.Iterator(im)]
    import cv2

    capture = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        capture.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return frames


def _to_float32(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _ensure_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def decode_video(name: str, image_shape=(64, 64, 3)) -> Tuple[np.ndarray, str]:
    """(video, reader): the (T, H, W, 3) float32 video in [0, 1] and which
    reader decoded it: "native", "pillow" or "opencv".

    Stacked-frame PNG/JPG goes through the native C++ decoder
    (native/monkeynet_io.cpp, built by data/native.py) when it builds and
    accepts the file, and through Pillow otherwise.
    """
    lower = name.lower()
    if lower.endswith((".png", ".jpg", ".jpeg")):
        from monkeynet_tpu_torch.data import native

        decoded = native.read_stacked(name, image_shape[0], image_shape[1])
        if decoded is not None:
            return decoded, "native"
        image = _ensure_rgb(_read_image(name))
        image = _to_float32(image)
        h, w = image_shape[0], image_shape[1]
        file_h = image.shape[0]
        total_w = image.shape[1]
        if h == w and total_w % file_h == 0:
            # Square request on a square-stacked file: frame boundaries are
            # the file's own frame size (width = T x height); slicing a
            # 128^2-frame file at a requested 64 would shear frames together.
            # Slice at the native size, then resize.
            native_size = file_h
            num_frames = total_w // native_size
            video = image.reshape(native_size, num_frames, native_size, image.shape[-1])
            video = np.ascontiguousarray(np.transpose(video, (1, 0, 2, 3)))
            if native_size != h:
                import cv2

                video = np.stack(
                    [cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA) for f in video]
                )
            return video, "pillow"
        # Non-square frames (or a width that does not tile by the height):
        # the reference's slice-by-image_shape semantics, frame t =
        # image[:, t*w:(t+1)*w].
        if file_h != h or total_w % w != 0:
            raise ValueError(
                f"stacked-frame image {image.shape[:2]} does not tile into "
                f"{(h, w)} frames ({name})"
            )
        num_frames = total_w // w
        video = image.reshape(h, num_frames, w, image.shape[-1])
        return np.ascontiguousarray(np.transpose(video, (1, 0, 2, 3))), "pillow"
    elif lower.endswith((".gif", ".mp4", ".mov")):
        video = np.stack([_ensure_rgb(f) for f in _read_frames(name)])
        return _to_float32(video), "pillow" if lower.endswith(".gif") else "opencv"
    raise ValueError(f"unknown video extension: {name}")


def read_video(name: str, image_shape=(64, 64, 3)) -> np.ndarray:
    """Decode a video file to (T, H, W, 3) float32 in [0, 1]."""
    return decode_video(name, image_shape)[0]


def write_stacked_png(path: str, video: np.ndarray) -> None:
    """Inverse of the stacked-frame format: (T, H, W, C) float [0,1] -> PNG."""
    from PIL import Image

    stacked = np.concatenate(list(video), axis=1)
    Image.fromarray((255 * np.clip(stacked, 0, 1)).astype(np.uint8)).save(path)


def write_gif(path: str, frames: np.ndarray) -> None:
    """frames: (T, H, W, C) float [0,1] or uint8; 10 frames a second."""
    from PIL import Image

    if frames.dtype != np.uint8:
        frames = (255 * np.clip(frames, 0, 1)).astype(np.uint8)
    images = [Image.fromarray(f) for f in frames]
    images[0].save(path, save_all=True, append_images=images[1:], duration=100, loop=0)
