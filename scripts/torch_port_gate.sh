#!/usr/bin/env bash
# The port's quality gate on one card, with the port's CLI.
#
#     bash scripts/torch_port_gate.sh [OUT_DIR] [shapes|actions|all]
#
# shapes: train configs/shapes.yaml as shipped, then run its eval modes on
# the last checkpoint (reconstruction prints L1 / AKD / AED; transfer over
# the config's pairs; the demo on the shapes checkpoint at 64^2; prediction
# as shipped).
# actions: train configs/actions.yaml as shipped (4500 steps: the device
# feed, 30 steps a dispatch through the step's CUDA graph, bf16, uint8),
# then reconstruct all 15 test videos of data/actions. Its limit is
# reconstruction L1 <= 0.031, twice the upper end of the JAX package's
# full-recipe 0.01482-0.01535 (RESULTS.md, a quality number); the script
# exits 1 above it.
#
# Checkpoints and bulky outputs stay under a temporary directory; OUT_DIR
# (default log/gate) receives each step's output, log.txt, the
# reconstruction's files and the demo gif. Each step's wall time is printed
# beside the card's name and power limit.
set -u
out=${1:-log/gate}
recipes=${2:-all}
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
echo "$card"

step() {  # step NAME COMMAND...: run, keep its output, print rc and wall time
    local name=$1
    shift
    local t0 t1 rc
    t0=$(date +%s.%N)
    "$@" > "$out/$name.out" 2>&1
    rc=$?
    t1=$(date +%s.%N)
    python3 -c "print('$name: rc $rc, wall ' + repr($t1 - $t0) + ' s on $card')"
    tail -n 5 "$out/$name.out"
    return $rc
}

gate_shapes() {
    step train python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode train \
        --log_dir "$work/shapes" || exit 1
    local run ckpt
    run=$(ls -d "$work"/shapes/*/ | head -n 1)
    cp "$run/log.txt" "$out/"
    ckpt=$(ls "$run"/*-checkpoint.pth.tar | sort | tail -n 1)
    echo "checkpoint: $(basename "$ckpt")"
    step reconstruction python -m monkeynet_tpu_torch.run --config configs/shapes.yaml \
        --mode reconstruction --checkpoint "$ckpt" || exit 1
    cp -r "$run/reconstruction" "$out/"
    step transfer python -m monkeynet_tpu_torch.run --config configs/shapes.yaml \
        --mode transfer --checkpoint "$ckpt" || exit 1
    echo "transfer: $(ls "$run/transfer/png" | wc -l) pairs written"
    step demo python -m monkeynet_tpu_torch.demo --config configs/shapes.yaml \
        --checkpoint "$ckpt" --image_shape 64,64 --out_file "$out/demo_shapes.gif" || exit 1
    step prediction python -m monkeynet_tpu_torch.run --config configs/shapes.yaml \
        --mode prediction --checkpoint "$ckpt" || exit 1
    echo "prediction: $(ls "$run/prediction/png" | wc -l) test videos rendered"
}

gate_actions() {
    step actions_train python -m monkeynet_tpu_torch.run --config configs/actions.yaml \
        --mode train --log_dir "$work/actions" || exit 1
    local run ckpt
    run=$(ls -d "$work"/actions/*/ | head -n 1)
    cp "$run/log.txt" "$out/actions_log.txt"
    ckpt=$(ls "$run"/*-checkpoint.pth.tar | sort | tail -n 1)
    echo "checkpoint: $(basename "$ckpt")"
    step actions_reconstruction python -m monkeynet_tpu_torch.run --config configs/actions.yaml \
        --mode reconstruction --checkpoint "$ckpt" || exit 1
    mkdir -p "$out/actions_reconstruction"
    cp -r "$run/reconstruction/png" "$out/actions_reconstruction/"
    python3 - "$out/actions_reconstruction.out" <<'EOF' || exit 1
import sys

l1 = [float(line.split(":")[1]) for line in open(sys.argv[1])
      if line.startswith("Reconstruction loss:")]
if len(l1) != 1 or not l1[0] <= 0.031:
    sys.exit(f"actions: reconstruction L1 {l1} above the 0.031 limit")
print(f"actions: reconstruction L1 {l1[0]} within the 0.031 limit")
EOF
}

case "$recipes" in
    shapes) gate_shapes ;;
    actions) gate_actions ;;
    all) gate_shapes; gate_actions ;;
    *) echo "unknown recipe set '$recipes' (shapes, actions or all)" >&2; exit 2 ;;
esac
