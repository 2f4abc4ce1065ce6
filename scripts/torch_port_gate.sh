#!/usr/bin/env bash
# The port's quality gate on one card: train configs/shapes.yaml as shipped
# with the port's CLI, then run its eval modes on the last checkpoint
# (reconstruction prints L1 / AKD / AED; transfer over the config's pairs;
# the demo on the shapes checkpoint at 64^2; prediction as shipped).
#
#     bash scripts/torch_port_gate.sh [OUT_DIR]
#
# Checkpoints and bulky outputs stay under a temporary directory; OUT_DIR
# (default log/gate) receives each step's output, log.txt, the
# reconstruction's files and the demo gif. Each step's wall time is printed
# beside the card's name and power limit.
set -u
out=${1:-log/gate}
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

step train python -m monkeynet_tpu_torch.run --config configs/shapes.yaml --mode train \
    --log_dir "$work" || exit 1
run=$(ls -d "$work"/*/ | head -n 1)
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
