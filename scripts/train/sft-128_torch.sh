#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of sft-128.sh: the same environment
# variables and flags, run through trace_tpu_torch.train.cli (on the CUDA card).
# Stage-2 SFT (reference: scripts/train/sft-128.sh): unfreeze backbone,
# lr 5e-6, 2 epochs, jittered 'rand' frame sampling.
python -m trace_tpu_torch.train.cli \
  --stage sft \
  --data-path "${DATA_PATH:?}" --data-folder "${DATA_FOLDER:-}" \
  --init-checkpoint "${INIT_CKPT:?}" \
  --output-dir "${OUTPUT_DIR:-runs/stage2}" \
  --num-frames 128 --batch-size "${BATCH:-8}" --epochs 2 \
  --sample-scheme rand --save-steps 5000 "$@"
