#!/usr/bin/env python3
"""What chip_smoke.py's train-parity phase reads when a warp backward kernel
is wrong, beside what it reads on the sound kernels.

    python3 scripts/train_parity_mutation.py

For the sound sources and for each mutation below, the port, the configs and
chip_smoke.py are copied into a temporary directory, one line of one CUDA
source is replaced there, and chip_smoke.train_parity runs in that copy (it
builds the kernels of the copy). The repository itself is never changed. One
JSON line per case: the card-vs-CPU gaps and whether the phase accepted them.
The script fails unless the sound kernels pass and every mutation is refused.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = "monkeynet_tpu_torch/csrc"
# name -> (source, the sound text, the wrong text)
MUTATIONS = {
    "sound": None,
    # the un-normalisation of align_corners=False: 1.6% too large at W = 64
    "dgrid_scale": (f"{CSRC}/warp_dgrid.cu", "gx * 0.5f * (float)(W - 1)",
                    "gx * 0.5f * (float)W"),
    # the weights of the (x1, y0) and (x0, y1) corners exchanged
    "dsrc_corners": (f"{CSRC}/warp_dsrc.cu", "tp.wx1 * tp.wy0, tp.wx0 * tp.wy1,",
                     "tp.wx0 * tp.wy1, tp.wx1 * tp.wy0,"),
}
RUN = """
import chip_smoke
from monkeynet_tpu_torch.utils.config import load_config
chip_smoke.full_f32()
chip_smoke.train_parity(load_config("configs/taichi.yaml"))
"""


def run_case(name: str, mutation) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for item in ("monkeynet_tpu_torch", "configs"):
            shutil.copytree(REPO / item, root / item,
                            ignore=shutil.ignore_patterns("_kernels_build", "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", root)
        if mutation is not None:
            source, sound, wrong = mutation
            text = (root / source).read_text()
            if text.count(sound) != 1:
                raise SystemExit(f"{name}: {sound!r} occurs {text.count(sound)} times in {source}")
            (root / source).write_text(text.replace(sound, wrong))
        done = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True,
                              text=True, timeout=600)
    lines = [line for line in done.stdout.splitlines() if '"train_parity"' in line]
    if not lines:
        raise SystemExit(f"{name}: train_parity printed no reading\n{done.stderr[-2000:]}")
    reading = json.loads(lines[-1])
    return {"case": name, "accepted": done.returncode == 0,
            "card_vs_cpu": reading["card_vs_cpu"], "tol": reading["tol"],
            "refusal": done.stderr.strip().splitlines()[-1] if done.returncode else None}


def main() -> int:
    ok = True
    for name, mutation in MUTATIONS.items():
        result = run_case(name, mutation)
        print(json.dumps(result), flush=True)
        ok &= result["accepted"] == (mutation is None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
