#!/bin/bash
# The checkpoint-parity runbook on the PyTorch/CUDA port, without JAX:
# weights dir -> manifest check -> conversion -> gated real-checkpoint tests
# -> event-triplet diff -> quality eval (bf16 + int8). The stages of
# run_all.sh, through trace_tpu_torch alone.
#
# Usage:
#   scripts/parity/run_all_torch.sh /path/to/trace-ckpt \
#       [--vision /path/to/clip-vit-large-patch14-336] \
#       [--video demo.mp4] \
#       [--anno /path/to/youcook2 --videos /path/to/videos]   # enables eval
#
# Runs what the inputs allow and prints a PASS / FAIL / SKIP line per stage:
#   0. manifest key/shape verification  (python -m trace_tpu_torch.checkpoint.manifest)
#   1. conversion + model_init smoke    (python -m trace_tpu_torch.checkpoint.runbook convert)
#   2. gated real-checkpoint tests      (tests/test_torch_real_checkpoint.py)
#   3. event-triplet diff bf16 vs int8  (needs --video; runbook triplets)
#   4. quality eval at matched metrics  (needs --anno/--videos; bf16 + int8)
set -u
cd "$(dirname "$0")/../.."

CKPT="${1:?usage: run_all_torch.sh CKPT_DIR [--vision DIR] [--video FILE] [--anno DIR --videos DIR]}"
shift
VISION=""; VIDEO=""; ANNO=""; VIDEOS=""
while [ $# -gt 0 ]; do
  case "$1" in
    --vision) VISION="$2"; shift 2;;
    --video)  VIDEO="$2";  shift 2;;
    --anno)   ANNO="$2";   shift 2;;
    --videos) VIDEOS="$2"; shift 2;;
    *) echo "unknown arg: $1"; exit 2;;
  esac
done
VFLAG=()
[ -n "$VISION" ] && VFLAG=(--vision-path "$VISION")

status() { printf '%-28s %s\n' "$1" "$2"; }

echo "=== stage 0: manifest verification ==="
if python -m trace_tpu_torch.checkpoint.manifest --verify "$CKPT"; then
  status "manifest" PASS
else
  status "manifest" "FAIL (layout mismatch — fix before proceeding)"
  exit 1
fi

echo "=== stage 1: conversion + model_init smoke ==="
if python -m trace_tpu_torch.checkpoint.runbook convert "$CKPT" ${VFLAG[@]+"${VFLAG[@]}"}; then
  status "conversion" PASS
else
  status "conversion" FAIL; exit 1
fi

echo "=== stage 2: real-checkpoint gated tests (sanity + int8 margin) ==="
if TRACE_TPU_REAL_CKPT="$CKPT" TRACE_TPU_REAL_VISION="$VISION" \
      python -m pytest --noconftest -p no:cacheprovider tests/test_torch_real_checkpoint.py -q; then
  status "real-ckpt-tests" PASS
else
  status "real-ckpt-tests" FAIL
fi

echo "=== stage 3: event-triplet diff (bf16 vs int8 serving) ==="
if [ -n "$VIDEO" ]; then
  python -m trace_tpu_torch.checkpoint.runbook triplets "$CKPT" "$VIDEO" ${VFLAG[@]+"${VFLAG[@]}"}
  status "triplet-diff" DONE
else
  status "triplet-diff" "SKIP (pass --video FILE)"
fi

echo "=== stage 4: quality eval (Youcook2 DVC, bf16 then int8) ==="
if [ -n "$ANNO" ] && [ -n "$VIDEOS" ]; then
  for q in bf16 int8; do
    python -m trace_tpu_torch.eval.evaluate --task dvc --model-path "$CKPT" \
      --anno-path "$ANNO" --video-path "$VIDEOS" --split val \
      --batch-size 32 --quant "$q" --output-dir "parity_eval_$q" ${VFLAG[@]+"${VFLAG[@]}"}
  done
  status "quality-eval" "DONE (compare parity_eval_bf16 vs parity_eval_int8; accept int8 if CIDEr/METEOR/SODA_c/F1 move < 0.1 abs — BASELINE.md gate: 8.1/2.8/2.2/22.4)"
else
  status "quality-eval" "SKIP (pass --anno DIR --videos DIR)"
fi

echo "run_all complete."
