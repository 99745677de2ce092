#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of pretrain-128.sh: the same environment
# variables and flags, run through trace_tpu_torch.train.cli (on the CUDA card).
# Stage-1 pretraining (reference: scripts/train/pretrain-128.sh):
# freeze LM backbone; tune connector (lr 1e-3) + time/score/sync towers +
# aux heads; 128 frames; bf16; cosine 3% warmup; 1 epoch.
python -m trace_tpu_torch.train.cli \
  --stage pretrain \
  --data-path "${DATA_PATH:?set DATA_PATH to the stage-1 annotation json}" \
  --data-folder "${DATA_FOLDER:-}" \
  --init-checkpoint "${INIT_CKPT:?set INIT_CKPT to the trace-init dir}" \
  --output-dir "${OUTPUT_DIR:-runs/stage1}" \
  --num-frames 128 --batch-size "${BATCH:-8}" --epochs 1 \
  --save-steps 2000 "$@"
