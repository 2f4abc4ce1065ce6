"""Single-pair motion-transfer demo on the card.

    python -m monkeynet_tpu_torch.demo --config configs/moving-gif.yaml \\
        --checkpoint <.pth.tar, or the JAX package's .msgpack>

Counterpart of the repository's demo.py (the JAX package's; reference
demo.py:23-71). Defaults to the bundled demo pair, data/demo/driving.png (a
stacked-frame driving video) and data/demo/source.png (its first frame is
the source), at 128^2: detects the keypoints of both, normalises the
driving keypoints with the config's transfer recipe (tasks/transfer.py
`transfer_one`), animates the source and writes a gif.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_demo(config, checkpoint, driving_video, source_image, out_file,
             image_shape=(128, 128), device="cuda"):
    """Animate `source_image` with `driving_video` into the gif `out_file`;
    return transfer_one's numpy outputs."""
    from monkeynet_tpu_torch.data.io import read_video, write_gif
    from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor
    from monkeynet_tpu_torch.tasks.reconstruction import load_eval_models
    from monkeynet_tpu_torch.tasks.transfer import transfer_one
    from monkeynet_tpu_torch.utils.config import load_config
    from monkeynet_tpu_torch.utils.device import require_device

    device = require_device(device)
    if isinstance(config, str):
        config = load_config(config)
    shape = tuple(image_shape) + (3,)

    driving = read_video(driving_video, shape)[None]  # (1, D, H, W, C)
    source = read_video(source_image, shape)[None, :1]

    generator, kp_detector = load_eval_models(config, checkpoint, device)
    out = transfer_one(Animator(generator, device=device),
                       KPExtractor(kp_detector, device=device),
                       source, driving, config["transfer_params"])
    write_gif(out_file, out["video_prediction"][0])
    print(f"wrote {out_file}")
    return out


def main(argv=None) -> int:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out_file", default="demo.gif")
    parser.add_argument("--driving_video",
                        default=os.path.join(_REPO, "data", "demo", "driving.png"))
    parser.add_argument("--source_image",
                        default=os.path.join(_REPO, "data", "demo", "source.png"))
    parser.add_argument("--image_shape", default=(128, 128),
                        type=lambda x: tuple(int(a) for a in x.split(",")))
    opt = parser.parse_args(argv)
    run_demo(opt.config, opt.checkpoint, opt.driving_video, opt.source_image, opt.out_file,
             opt.image_shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
