#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of sft-youcook2.sh: the same environment
# variables and flags, run through trace_tpu_torch.train.cli (on the CUDA card).
# Youcook2 fine-tune (reference: scripts/train/sft-youcook2.sh): start from
# the stage-2 SFT checkpoint, same hyperparameters, dense-caption data only.
python -m trace_tpu_torch.train.cli \
  --stage sft \
  --data-path "${DATA_PATH:?}" --data-folder "${DATA_FOLDER:-}" \
  --init-checkpoint "${INIT_CKPT:?}" \
  --output-dir "${OUTPUT_DIR:-runs/youcook2-ft}" \
  --num-frames 128 --batch-size "${BATCH:-8}" --epochs 3 \
  --sample-scheme rand --save-steps 1000 "$@"
