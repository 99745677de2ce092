#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of eval.sh: the same environment
# variables and flags, run through trace_tpu_torch.eval.evaluate (on the CUDA card).
# VTG evaluation (reference: trace/eval/eval.sh three-process chain,
# collapsed into one in-process driver): evaluate -> reformat -> metrics.
TASK=${1:?usage: eval.sh <dvc|tvg|vhd> }
python -m trace_tpu_torch.eval.evaluate \
  --model-path "${MODEL_PATH:?}" \
  --task "$TASK" \
  --anno-path "${ANNO_PATH:?}" \
  --video-path "${VIDEO_PATH:?}" \
  --split "${SPLIT:-test}" \
  --num-frames "${FRAMES:-128}" --batch-size "${BATCH:-4}" \
  --output-dir "${OUTPUT_DIR:-eval_out}" "${@:2}"
