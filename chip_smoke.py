#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving and training paths from csrc/
     (nvcc, parallel);
  3. each kernel against its plain PyTorch version at the shapes its path
     gives it (the three bf16 attention kernels; the int8 weight product, 2-D
     and stacked; int8 decode attention in both modes; the nibble-packed int4
     weight products, per channel and grouped, each in its split-K form at
     M = 2 and its tensor-core form at M = 3886, the grouped one also at
     M = 32, its 64-row tile, printed apart; the bf16 decode attention also
     at decode batch 32 with random and with serving masks, and the int8
     one at decode batch 32, also at phase 5's arena length (S = 2560) with
     serving masks, printed apart; the int8 products in both forms, up to
     8 rows of x and the wide tile at M = 32, phase 5's decode batch, each
     a row of its own; the training attention:
     forward with the logsumexp residual, backward dq and backward dk/dv), with its time (CUDA
     events, median of 20, L2 flushed between runs), the plain version's
     time, the time of one PyTorch library call computing the same function
     (a yardstick only, never called by the port) and the least time the
     card could take (the larger of bytes / 3.35 TB/s and operations over
     the peak rate of their type, 989 TFLOP/s bf16 or 1979 TOP/s int8, the
     H100 SXM data-sheet rates); beside the backward, informational, SDPA's
     flash backend on the same q / k / v with is_causal and no bias. Then
     the fp32 form of every row (``*_f32``, csrc/*_f32.cu: the attention
     forward (rows 1, 2, 8) and the backward's dq and dk/dv three TF32
     products on the tensor cores for each fp32 product, bound against
     495 TFLOP/s with the CUDA-core bound printed beside, the forward also
     repeated bit for bit; the weight products past 8 rows of x two TF32
     products, bound likewise, the int8 one printed apart; the weight
     products up to 8 rows fp32 FMA on the CUDA cores; the decode rows the
     fp32 instances of the bf16 rows' cluster kernels) at the same shapes
     in fp32 (the decode rows also at B = 32, random and serving masks),
     bound otherwise against the fp32 CUDA-core peak of 67 TFLOP/s,
     yardsticks SDPA in fp32 and ``torch.matmul`` on the dequantized fp32
     weight, each held to its plain version (FP32_REL_NORM_TOL); and row 1
     with a query offset (a chunk of a chunked prefill over a cache
     stripe) against the plain chunked attention, bf16 and fp32; last every
     attention row (1, 2, 3, 3b, 8, 9, 10; bf16 and fp32) at open_llama_3b's
     head dim 100 beside hd 128 at 32 / 32 heads, with the time of its pad
     copies (``head_dim_checks``; the bf16 rows of phase 9's path are the
     entries ``*_hd100``); then rows 1, 8, 3 and 3b (both bodies) at
     Falcon3-7B's head dim 256 and at hd 192 (on copies padded to 256)
     beside hd 128 at its 12 / 4 heads, with rows 9 and 10 (the backward,
     from row 8's residuals, repeated bit for bit) beside them
     (``wide_head_dim_checks``; the hd-256 rows are the entries
     ``*_hd256``);
  4. the TRACE-7B serving path end to end at full width (CLIP ViT-L/14-336
     at the -2 tap, spatial_slot, Mistral-7B at SERVE_LAYERS = 8 of its 32
     layers, random weights from seed 0),
     first in bf16, then in the int8 serving configuration (int8 weights in
     the fused layout, int8 KV cache, W8A8 prefill and ViT), then in the
     int4p serving configuration (nibble-packed int4 layer weights with
     group-128 scales, weight-only at every chunk length; at a depth of 4
     layers): two requests
     of 2 synthetic 128-frame 336x336 videos, 64 new tokens each, launch
     counts checked per request, outputs checked against the same path with
     every kernel replaced by its plain version and against an fp32 model
     of the same (dequantized) weights. Last the same on a per-channel
     (group 0) int4p tree at a depth of 4 layers (W4A8 prefill, the
     per-channel kernel in the steps), and one request of it without
     activation quantization (the per-channel kernel in the prefill too).
     Then fp32 trees (TraceConfig(dtype=float32)) at F32_LAYERS layers in
     the int8, int4 and int4p serving configurations: a request each
     through the fp32 forms (rows 1, 2, 3b and 4-7), check (e), no plain
     version on the card, and a dequant request on the int8 one; and the
     chunked prefill: one request's prefix prefilled in two chunks through
     ``decoder_forward`` against the one-shot prefill, on the kernel and the
     plain route (bf16 at 32 layers, and the fp32 int8 tree), and the second
     chunk again with cache-mask slots inside and past it (two launches of
     row 8 a layer on the card), the kernel route against the plain one.
  5. the bench's serving workload (bench.py's int8 defaults, cut to 64 of its
     192 videos and CORPUS_LAYERS = 8 of 32 layers) through the port's entry points at full
     width: TRACE-7B in the int8 serving
     configuration with the W8A8 ViT and ``upload_format="yuv420"``, random
     weights from seed 0, ``SpmLikeTokenizer``; a pool of 4 synthetic
     640x360 128-frame videos prepared with ``prepare_sample_host_np`` before
     timing and cycled through a corpus of 64 (two decode chunks):
     ``infer_events_corpus`` at decode batch 32, prefill sub-batches of 2,
     encode batches of 2 and a 512-token arena, once two-phase with 256 new
     tokens (pass A), once streamed with 512 (pass B). Per pass videos/s,
     ``last_corpus_stats``, ms per decode step at B = 32 and the launches of
     rows 1, 2, 3b, 4 and 5; peak memory, and where it is set (set-up, the
     encode before the first prefill, the rest of each pass); one B = 32
     decode step under torch.profiler. Checks: (a) pass A's tokens are the
     first 256 of pass B's, row for row; (b) ``i420_band_to_patches`` on the
     card against the CPU (bf16: one step, in at most 1e-3 of the
     elements); (c) the first-token logits of pass A's first prefill
     sub-batch: the kernel path no further from an fp32 model of the
     dequantized weights than REF_RATIO_TOL x the plain path; (d) each of
     those rows launched (the int8 products in their wide form), no plain
     version called on the card; (e) each of
     those rows on the path's own inputs (an encode batch, that prefill
     sub-batch, a B = 32 decode step on pass B's arena): the first call of
     each wrapper at each shape against its plain version on the same
     inputs, held to its limits in phase 3.
  6. the training path at full width: ``train_loop`` on TRACE-7B bf16 (random
     weights from seed 0, 2 synthetic 128-frame videos with one event list
     each, batch 2, remat on) for stage ``pretrain`` and stage ``lora``
     (rank 128 on the seven decoder projections) at a depth of TRAIN_LAYERS = 4 layers,
     then stage ``sft`` at a depth of 4 layers. Per stage a 1-step run (the schedule starts at 0: no
     trainable leaf may move), a 2-step run (every trainable group must have
     moved) and the 4-step run that is timed: losses finite, frozen leaves
     bit-equal before and after, launch counts per step as the code implies,
     peak memory printed; one ``pretrain`` step under torch.profiler, with
     the device time of the training attention kernels in it. Last, at
     the 4-layer depth, one forward_train + backward through the kernels
     against the same with every kernel replaced by its plain version and
     against an fp32 model of the same weights: the loss and the gradients of
     the connector, the towers and decoder layer 0. Last, two ``lora``
     steps of an fp32 model at SFT_LAYERS layers through the fp32 forms of
     rows 2 and 8-10.
  7. a TRACE-7B checkpoint of the released merged layout (690 keys, bf16,
     random values) written to a temporary directory and served through the
     public API: ``model_init`` in bf16, int8 and int4, ``infer_events`` on
     an ``.npy`` of 256 640x360 frames and on ``.mp4`` files of such frames
     (cv2.VideoWriter, mp4v), read on the route ``video.io
     .container_reader`` names (OpenCV where the native decoder does not
     build), ``serve`` over the ``.npy`` files and one that does not load,
     and over the ``.mp4`` files and a junk one (see ``checkpoint_phase``);
     then ``model_init(dtype=torch.float32)`` (one request through the fp32
     forms of rows 1-3, its prefill logits against the fp32 plain path's
     beside the bf16 kernel path's) and ``python -m
     trace_tpu_torch.checkpoint.manifest --verify`` on the directory and on
     a copy without one shard.
  8. the evaluation entry points on a checkpoint of that layout at
     EVAL_LAYERS = 8 of its 32 decoder layers and on those videos
     (``eval_phase``): ``eval.evaluate.main`` for tvg in bf16,
     ``runtime.inference.main``, ``run_vtg_eval`` for dvc in int8 scored
     as dvc, dvc-anet and vhd, ``run_mvbench`` on JPEG frame dumps and on
     ``.mp4`` clips, and ``run_videomme`` on phase 7's ``.mp4`` files.
  9. the other backbones at full width and a depth of FAMILY_LAYERS = 4 layers, each from a merged checkpoint
     written here and loaded through ``model_init`` (``families_phase``):
     qwen2-7B (G = 7, qkv biases) with spatial_slot, two requests in bf16
     and two in int8, and vicuna-7B with stc_connector_v35 (the
     global-pooling layout), two in bf16: launch counts, head slices, check
     (e) and the distance to an fp32 model; rows 3 and 3b at G = 7 (phase
     3's ``*_g7`` entries, with a G = 16 split and the prefill at G = 7
     beside them) take their launches from this path. Then a decoder
     shaped like open_llama_3b (hd 100, 32 / 32 heads) with spatial_slot,
     two requests in bf16 and two in int8 (check (e) of rows 1, 3 and 3b
     in both bodies), and one ``lora`` step of it at HD_LORA_LAYERS layers
     (check (e) of rows 8-10): the ``*_hd100`` entries' launches. Then a
     decoder shaped like Falcon3-7B (hd 256, 12 / 4 heads, I 23040) with
     spatial_slot, two requests in bf16 and two in int8 (check (e) of rows
     1, 3 and 3b in both bodies), a chunk of its bf16 prefill with marked
     cache slots (two launches of row 8 a layer), and one ``lora`` step of
     it at HD_LORA_LAYERS layers (check (e) of rows 8-10 at hd 256): the
     ``*_hd256`` entries' launches.
 10. Mixtral-8x7B at its published widths and a depth of 4 of 32 layers
     (``moe_phase``), from a checkpoint in HF Mixtral key names written
     here: ``model_init`` bf16 (the dense mixture), two requests, the fp32
     reference check with each layer's routing flips; the same tree in the
     sparse form with the int8 KV cache; ``model_init(quant="int8")``
     raising; two ``lora`` steps at batch 1 x 2048 through the routed
     layers.
 11. the parallel paths (``parallel_phase``): 2 ranks on the one card, a gloo
     group over CUDA tensors (NCCL refuses two ranks on one device), a
     (data 1, model 2) mesh and a 2-stage pipeline mesh. Tensor-parallel
     serving of phase 4's TRACE-7B (at PAR_SERVE_LAYERS = 8 of its 32
     layers, seed 0) in bf16 and in the
     int8 serving configuration through ``shard_params_for_inference``,
     ``encode_prefix_sharded`` (frame-parallel ViT) and ``generate_sharded``,
     phase 4's two requests each: launch counts of rows 1, 2, 3 / 3b, 4 and 5
     per rank and request, check (e) at the local shapes, the ranks' tokens
     equal, the first-token logits no further from the fp32 model than
     REF_RATIO_TOL x the one-rank kernel path's (built here at the same
     depth); an int4p tree refused. One
     Mixtral-8x7B layer, 4 experts a rank, both forms, against the one-rank
     layer. ``pp_decoder_forward`` at full width, 8 layers, 2 stages x 2
     microbatches, B 2 x T 2048: output and gradients against
     ``decoder_forward`` on one rank. PAR_TRAIN_STEPS ``lora`` steps of
     ``train_loop(mesh=...)`` at 4 layers, each step's loss and grad norm
     against one rank's. One request in the native int4 configuration at
     TP_INT4_LAYERS layers (per-channel packed shards packed on each rank)
     held to the same request on one rank. Per rank:
     encode s, prefill s, decode ms/step and the gloo collectives' share of
     the decode loop.
The line before the last is {"kernels": [...]} (each entry also holds
``launches_corpus``, its count in phase 5's pass A, ``launches_moe``, its
count on phase 10's path, and ``launches_parallel``, rank 0's on phase 11's);
the last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it prints no result and exits 2.
``--kernels`` stops after phase 3 (a short check of freshly edited kernels;
no last line); ``--checkpoint`` runs phase 7 alone, ``--eval`` phases 7 and
8, ``--families`` phase 9 alone, ``--moe`` phase 10 alone and
``--parallel`` phase 11 alone (each after the build; no last line);
``--runbook`` runs scripts/parity/run_all_torch.sh on a checkpoint of phase
7's writer.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16, data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8, data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 on the CUDA cores (not TF32), data sheet
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32, data sheet
SEED = 0
FRAMES = 128
VIDEOS = 2
MAX_NEW = 64
# bf16 kernel vs plain, per kernel: |diff| <= atol + rtol |ref| element by
# element, and ||diff|| / ||ref|| <= REL_NORM_TOL. Both versions round the
# output to bf16 and the probabilities to bf16 before P.V (the flash kernels
# at other points of the online softmax), so they differ by about one bf16
# step of the output: rtol is two steps (2^-7). Each atol is about twice the largest
# difference measured at these shapes and inputs (NVIDIA H100 80GB HBM3,
# 700 W: 0.0156 / 0.0039 / 0.00098): flash's early rows average few keys,
# |o| up to ~4, where a step is 2^-6; a ViT output averages 577 keys,
# |o| < 1; a decode output averages ~1150 keys, |o| < 0.25. The norm
# limit is ~3x a bf16 step of the output (2^-8): a kernel that drops or
# doubles a fraction of its key tiles or chunks moves it by far more.
#
# The int8 weight product sums the same exact products (bf16 x int8) in fp32
# in another order than the plain version: over K <= 14336 terms the sums
# differ by ~sqrt(K) eps of their size, far under 1e-5 of the largest output,
# so outputs are compared in units of max |ref| with atol 1e-5 and, for the
# rows with bf16 outputs, rtol of two bf16 steps for a rounding that flips.
# int8 decode attention: the integer sums are exact and every fp32 step
# that feeds a rounding is the plain version's, so the two differ only where
# expf and torch.exp round a probability apart: the sum l moves by ~1e-7 of
# itself, and a quantized p * vs that lay on a half flips by one step, which
# moves an output by at most ps * 127 / l (~0.004 of the largest output
# here, where ~1150 slots share the weight); then the output's bf16 rounding
# can flip (rtol 2^-7). dequant sums fp32 in another order besides. atol as
# for the bf16 decode kernel (|o| < 0.25).
# The packed-int4 products sum exact products too (bf16 x a nibble; grouped,
# bf16 x the scaled weight rounded to bf16, which kernel and plain version
# round alike: nibble x scale is exact in fp32 and in the kernel's bf16
# multiply, and both round it once to nearest even). The split-K form
# multiply-adds in fp32 like the int8 product: its limits. The tensor-core
# form adds each 16 products into the fp32 accumulator inside wgmma, which
# truncates where an fp32 add rounds to nearest; over K / 16 <= 896 steps the
# sum drifts by up to ~K / 16 x 2^-24 of the largest partial sum, so 1e-4 of
# the largest output (a dropped k step or a misplaced nibble moves outputs by
# 1e-2 and more); bf16 outputs two bf16 steps relative as above.
# The training attention. flash_attention_fwd_res is the forward kernel with
# one more output: o is held to flash_attention's limits, and lse (fp32 on
# both sides, the same exact products summed in another order, exp and log of
# two libraries) to LSE_TOL absolute on values of a few units. The backward
# kernels round p and ds to bf16 before their second product (p^T do, ds k,
# ds^T q) where the plain version keeps them in fp32; both round the result
# to bf16. A gradient element sums up to 2048 x 4 signed terms, so its error
# is a fraction of the gradient's typical size, not of its own value: limits
# in units of max |ref|, atol 1e-2 (the largest difference measured at this
# shape is ~1.5e-3 of max |ref|; NVIDIA H100 80GB HBM3, 700 W), rtol two bf16
# steps, and the norm limit as above (measured 2.6e-3, the rounding of p and
# ds; a dropped or doubled tile moves it by far more).
LSE_TOL = 1e-4
KERNEL_TOL = {  # name: (atol, rtol)
    "flash_attention_fwd_res": (3e-2, 2 ** -7),
    "flash_attention_bwd_dq": (1e-2, 2 ** -7),    # units of max |ref|
    "flash_attention_bwd_dkv": (1e-2, 2 ** -7),   # units of max |ref|
    "flash_attention": (3e-2, 2 ** -7),
    "vit_attention_btd": (8e-3, 2 ** -7),
    "decode_attention": (2e-3, 2 ** -7),
    "quant_matmul": (1e-5, 1e-5),           # fp32 out, in units of max |ref|
    "quant_matmul_stacked": (1e-5, 2 ** -7),  # bf16 and fp32 outs, same units
    "quant_matmul_wide": (1e-5, 1e-5),      # the wide form (M > 8): the same limits
    "quant_matmul_stacked_wide": (1e-5, 2 ** -7),
    "decode_attention_int8_s8dot": (2e-3, 2 ** -7),
    "decode_attention_int8_dequant": (2e-3, 2 ** -7),
    # rows 3 and 3b at qwen2-7B's group of 7 query rows a kv head: the same
    # arithmetic, the same limits
    "decode_attention_g7": (2e-3, 2 ** -7),
    "decode_attention_int8_s8dot_g7": (2e-3, 2 ** -7),
    "decode_attention_int8_dequant_g7": (2e-3, 2 ** -7),
    "quant_matmul_p4": (1e-5, 2 ** -7),          # split-K form, units of max |ref|
    "quant_matmul_p4_mma": (1e-4, 2 ** -7),      # tensor-core form, same units
    "quant_matmul_p4_grouped": (1e-5, 2 ** -7),
    "quant_matmul_p4_grouped_mma": (1e-4, 2 ** -7),
    # the fp32 forms (csrc/*_f32.cu, the decode kernels' fp32 instances): fp32
    # in and out, the same fp32 steps as
    # the plain version in another summation order, so they differ by fp32
    # rounding: attention and decode rows ~1e-6 of their values (limits 1e-4
    # absolute on outputs of a few units, 1e-4 relative), gradients in units
    # of max |ref| (1e-5; their products three TF32 products, ~2^-22 of each
    # fp32 product, each tile's sum promoted into a round-to-nearest one);
    # the weight products in units of max |ref|, 1e-5
    # (exact products, sums over K <= 14336 terms in another order; the
    # tensor-core form's x as two TF32 parts, within 2^-22 of it). The
    # dequant decode body rounds p to bf16 as the plain version does; where
    # the two p lie across a bf16 rounding point (p differs by an ulp) the
    # weight moves by one bf16 step: a few values a call by up to ~2e-4 (at
    # B = 32; its atol is the bf16 dequant row's), 4e-5 of the norm.
    # Their norm limit is FP32_REL_NORM_TOL (NORM_TOL)
    "flash_attention_f32": (1e-4, 1e-4),
    "vit_attention_btd_f32": (1e-4, 1e-4),
    "flash_attention_fwd_res_f32": (1e-4, 1e-4),
    "flash_attention_bwd_dq_f32": (1e-5, 1e-4),   # units of max |ref|
    "flash_attention_bwd_dkv_f32": (1e-5, 1e-4),  # units of max |ref|
    "decode_attention_f32": (1e-4, 1e-4),
    "decode_attention_int8_s8dot_f32": (1e-4, 1e-4),
    "decode_attention_int8_dequant_f32": (2e-3, 1e-4),  # the bf16 dequant row's atol
    "quant_matmul_f32": (1e-5, 0.0),             # units of max |ref|, both forms
    "quant_matmul_stacked_f32": (1e-5, 0.0),
    "quant_matmul_stacked_f32_tiled": (1e-5, 0.0),  # tensor-core form (M > 8)
    "quant_matmul_p4_f32": (1e-5, 0.0),          # split-K form
    "quant_matmul_p4_f32_tiled": (1e-5, 0.0),    # tensor-core form (M > 8)
    "quant_matmul_p4_grouped_f32": (1e-5, 0.0),
    "quant_matmul_p4_grouped_f32_tiled": (1e-5, 0.0),
}
# the rows at open_llama_3b's head dim 100 (``*_hd100``; head_dim_checks):
# the same arithmetic on zero-padded columns, the same limits
HD100_ROWS = ("flash_attention", "flash_attention_fwd_res", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "decode_attention", "decode_attention_int8_s8dot",
              "decode_attention_int8_dequant")
KERNEL_TOL.update({f"{base}_hd100": KERNEL_TOL[base] for base in HD100_ROWS})
# the rows at Falcon3's head dim 256 (``*_hd256``; wide_head_dim_checks): the
# same arithmetic at the kernels' width-256 instances, the same limits
HD256_ROWS = ("flash_attention", "flash_attention_fwd_res", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "decode_attention", "decode_attention_int8_s8dot",
              "decode_attention_int8_dequant")
KERNEL_TOL.update({f"{base}_hd256": KERNEL_TOL[base] for base in HD256_ROWS})
FP32_REL_NORM_TOL = 1e-4
# ||diff|| / ||ref|| limit of a row: REL_NORM_TOL, the fp32 forms' FP32_REL_NORM_TOL
NORM_TOL = {name: FP32_REL_NORM_TOL for name in KERNEL_TOL if "_f32" in name}
P4_SHAPES = (  # K, N, out dtype: wqkv, wo, w_gateup, w_down of a fused 7B layer
    (4096, 6144, "bfloat16"), (4096, 4096, "bfloat16"),
    (4096, 28672, "float32"), (14336, 4096, "bfloat16"))
PREFILL_M = 3886  # rows of the smoke's prefill: 2 x 1943 prefix tokens
REL_NORM_TOL = 1e-2
# end to end: the kernel path's distance from an fp32 reference may exceed
# the plain bf16 path's by this factor (see end_to_end)
REF_RATIO_TOL = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps=20, warmup=3):
    """Median CUDA-event time of fn, L2 flushed before each run."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, out, ref, rtol=None) -> dict:
    """Kernel output against the plain version's, on the rows that count:
    the largest difference, the largest excess over atol + rtol |ref|
    (> 0 fails), ||diff|| / ||ref|| and the RMS of ref. ``rtol`` replaces the
    kernel's own where an output type allows a tighter one."""
    atol, own_rtol = KERNEL_TOL[name]
    rtol = own_rtol if rtol is None else rtol
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    return {"err": diff.max().item(),
            "excess": (diff - atol - rtol * ref.abs()).max().item(),
            "rel_norm": (diff.norm() / ref.norm()).item(),
            "ref_rms": ref.square().mean().sqrt().item()}


def bound(bytes_moved: float, ops: float, ops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_line(name: str, r: dict, flops: float) -> None:
    """The achieved rate of an attention row and its share of its bound."""
    print(f"  {name}: {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * r['bound'][0] / r['ms']:.1f} % of its bound "
          f"({r['bound'][1]}, {r['bound'][0]:.4f} ms)", flush=True)


def kernel_checks(torch):
    """Phase 3: each kernel against its plain version at serving shapes."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import (
        flash_attention,
        vit_attention_btd,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    rows = {}

    # prefill flash attention: B=2, 32/8 heads, T=2048, hd=128, causal,
    # row 0 left-padded by 300 slots
    B, H, HKV, T, HD, PAD = 2, 32, 8, 2048, 128, 300
    q, k, v = randn(B, H, T, HD), randn(B, HKV, T, HD), randn(B, HKV, T, HD)
    bias = torch.zeros((B, T), device="cuda")
    bias[0, :PAD] = -1e30
    out = flash_attention(q, k, v, bias, True)
    ref = flash_attention(q, k, v, bias, True, impl="plain")
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("flash_attention: non-finite output")
    # every row; the left-padded ones see no key and get the mean of v
    cmp = compare("flash_attention", out, ref)
    causal_mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    lib_mask = torch.where(causal_mask[None, None], bias[:, None, None, :],
                           torch.tensor(-1e30, device="cuda")).to(torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                 enable_gqa=True)
    # what the function needs: the visible causal pairs; q rows and k/v
    # rows of real tokens read, every output row written
    visible = sum((T - p) * (T - p + 1) // 2 for p in (PAD, 0))  # per head
    flops = 4 * H * HD * visible
    real = 2 * T - PAD
    nbytes = (H + 2 * HKV) * real * HD * 2 + q.numel() * 2 + bias.numel() * 4
    rows["flash_attention"] = dict(
        **cmp, ms=median_ms(torch, lambda: flash_attention(q, k, v, bias, True)),
        plain_ms=median_ms(torch, lambda: flash_attention(q, k, v, bias, True, impl="plain")),
        library_ms=median_ms(torch, lib), bound=bound(nbytes, flops))
    rate_line("flash_attention", rows["flash_attention"], flops)
    del q, k, v, out, ref, lib_mask

    # ViT attention: one 16-frame chunk [16, 592, 1024], 16 heads x 64,
    # tq = 577; q/k/v are column slices of the fused QKV projection
    B, P, D, NH, TQ = 16, 592, 1024, 16, 577
    qkv = randn(B, P, 3 * D)
    q, k, v = qkv.split(D, dim=-1)
    out = vit_attention_btd(q, k, v, TQ, NH)
    ref = vit_attention_btd(q, k, v, TQ, NH, impl="plain")
    torch.cuda.synchronize()
    cmp = compare("vit_attention_btd", out[:, :TQ], ref[:, :TQ])
    heads = lambda x: x.view(B, P, NH, D // NH).transpose(1, 2)
    key_mask = (torch.arange(P, device="cuda") < TQ)[None, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                 attn_mask=key_mask)
    # the tq real tokens' q/k/v read and outputs written (pad rows need
    # nothing)
    flops = 4 * B * NH * TQ * TQ * (D // NH)
    nbytes = 4 * B * TQ * D * 2
    rows["vit_attention_btd"] = dict(
        **cmp, ms=median_ms(torch, lambda: vit_attention_btd(q, k, v, TQ, NH)),
        plain_ms=median_ms(torch, lambda: vit_attention_btd(q, k, v, TQ, NH, impl="plain")),
        library_ms=median_ms(torch, lib), bound=bound(nbytes, flops))
    rate_line("vit_attention_btd", rows["vit_attention_btd"], flops)
    del qkv, q, k, v, out, ref

    # decode attention: L=32, B=4, S=2304, layer 17's stripe, half the
    # slots masked
    L, B, H, NKV, S, HD, LI = 32, 4, 32, 8, 2304, 128, 17
    q = randn(B, H, 1, HD)
    ck, cv = randn(L, B, NKV, S, HD), randn(L, B, NKV, S, HD)
    bias = torch.where(torch.rand((B, S), generator=g, device="cuda") < 0.5,
                       0.0, -1e30).float()
    out = decode_attention(q, ck[LI], cv[LI], bias)
    ref = decode_attention(q, ck[LI], cv[LI], bias, impl="plain")
    torch.cuda.synchronize()
    cmp = compare("decode_attention", out, ref)
    lib_mask = bias[:, None, None, :].to(torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(q, ck[LI], cv[LI], attn_mask=lib_mask,
                                                 enable_gqa=True)
    # a masked slot adds exactly 0 (exp(-1e30 - m) underflows): the
    # function needs the K and V rows of the visible slots only
    visible = int((bias == 0).sum().item())  # (row, slot) pairs
    flops = 4 * (H // NKV) * NKV * visible * HD
    nbytes = (2 * q.numel() + 2 * visible * NKV * HD) * 2 + bias.numel() * 4
    rows["decode_attention"] = dict(
        **cmp, ms=median_ms(torch, lambda: decode_attention(q, ck[LI], cv[LI], bias)),
        plain_ms=median_ms(torch, lambda: decode_attention(q, ck[LI], cv[LI], bias,
                                                           impl="plain")),
        library_ms=median_ms(torch, lib), bound=bound(nbytes, flops))
    del q, ck, cv, out, ref, lib_mask
    bf16_decode_batch_checks(torch)

    quant_matmul_checks(torch, g, rows)
    int8_decode_checks(torch, g, rows)
    group_decode_checks(torch, rows)
    packed_int4_checks(torch, g, rows)
    flash_backward_checks(torch, g, rows)

    fp32_kernel_checks(torch, rows)
    query_offset_checks(torch)
    head_dim_checks(torch, rows)
    wide_head_dim_checks(torch, rows)

    for name, r in rows.items():
        atol, rtol = KERNEL_TOL[name]
        norm = NORM_TOL.get(name, REL_NORM_TOL)
        print(f"kernel {name}: max_abs_err={r['err']:.6g} (|diff| <= {atol} + "
              f"{rtol} |ref|, excess {r['excess']:.6g}) rel_norm_err="
              f"{r['rel_norm']:.6g} (tol {norm}) ref_rms={r['ref_rms']:.4f} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= norm):
            fail(f"{name}: kernel disagrees with its plain version")
    return rows


def fp32_kernel_checks(torch, rows: dict) -> None:
    """The fp32 form of every row (csrc/*_f32.cu; the decode rows' fp32
    instances of csrc/decode_attention*.cu, the weight products' split form
    the fp32 instances of csrc/qmm_split.cuh) against its plain version at the
    bf16 row's shapes, fp32 operands: K1 rows 1, 2 and 8 (``flash_attention``,
    ``vit_attention_btd``, ``flash_attention_fwd_res`` with its lse; three
    TF32 products for each product on the tensor cores, each repeated bit
    for bit), K2 rows 3 and 3b in both
    modes at B = 4 (the row) and B = 32 with random and serving masks
    (printed apart), K3 rows 4-7 at
    M = 2 (split K; M = 8 printed apart, each repeated bit for bit) and the
    packed ones at M = 3886 (the tensor-core form;
    the int8 one at M = 37, untimed, folded into its row, and at M = 3886
    timed and printed apart: no path launches it, the fp32 int8 tree
    prefills W8A8), K4 rows 9-10. Bound: the larger of bytes / 3.35 TB/s
    and operations / 67 TFLOP/s (the fp32 CUDA-core peak: rows 3 and 3b),
    for the weight products (both forms) two products'
    operations / 495 TFLOP/s (TF32, x split into two TF32 parts; the
    CUDA-core bound printed beside it), for rows 1, 2, 8, 9 and 10 three
    products' (both operands split; likewise);
    yardsticks: SDPA in fp32 for the attention rows, ``torch.matmul`` of
    fp32 x with the dequantized fp32 weight for rows 4-7 (TF32 off)."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels import quant_matmul as qmm
    from trace_tpu_torch.kernels.decode_attention import INT8_MODES, decode_attention
    from trace_tpu_torch.kernels.decode_int8_turns import mask_bias
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.model.mistral import _quantize_kv
    from trace_tpu_torch.model.quantize import dequantize

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    def row(name, fn, lib, nbytes, ops, reps=20, keep=True, label=None, rows_of=None,
            peak=FP32_FLOPS_PER_S, tf32_products="two"):
        out, ref = fn(), fn("plain")
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        parts = []
        for a, b in zip(outs, refs):
            if not torch.isfinite(a).all():
                fail(f"{name}: non-finite output")
            if rows_of is not None:
                a, b = rows_of(a), rows_of(b)
            unit = b.abs().max() if name.startswith(("quant", "flash_attention_bwd")) else 1.0
            r = compare(name, a / unit, b / unit)
            r["err"] *= float(unit)
            parts.append(r)
        r = {k: max(p[k] for p in parts) for k in ("err", "excess", "rel_norm")}
        r.update(ref_rms=parts[0]["ref_rms"], ms=median_ms(torch, fn, reps),
                 plain_ms=median_ms(torch, lambda: fn("plain"), reps),
                 library_ms=median_ms(torch, lib, reps), bound=bound(nbytes, ops, peak))
        peak_name = ("fp32 CUDA-core peak 67" if peak == FP32_FLOPS_PER_S
                     else f"{tf32_products} TF32 products at {peak / 1e12:.0f}")
        print(f"  {label or name} (fp32): ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}; {peak_name} TFLOP/s, "
              f"{100 * r['bound'][0] / r['ms']:.1f} %) max_abs_err={r['err']:.3g} "
              f"(excess {r['excess']:.3g}) rel_norm_err={r['rel_norm']:.3g} "
              f"(tol {FP32_REL_NORM_TOL})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= FP32_REL_NORM_TOL):
            fail(f"{label or name} (fp32): kernel disagrees with its plain version")
        if keep:
            rows[name] = r
        return r, outs

    # K1, row 1: the prefill shape of the bf16 row in fp32
    B, H, HKV, T, HD, PAD = 2, 32, 8, 2048, 128, 300
    q, k, v = randn(B, H, T, HD), randn(B, HKV, T, HD), randn(B, HKV, T, HD)
    bias = torch.zeros((B, T), device="cuda")
    bias[0, :PAD] = -1e30
    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    lib_mask = torch.where(causal[None, None], bias[:, None, None, :],
                           torch.tensor(-1e30, device="cuda"))
    visible = sum((T - p) * (T - p + 1) // 2 for p in (PAD, 0))
    flops = 4 * H * HD * visible
    real = 2 * T - PAD
    # rows 1, 2 and 8: three TF32 products for each product (both operands
    # split), the CUDA-core bound printed beside; a repeat is bit-equal
    def forward_row(name, fn, lib, nbytes, flops, reps=10, rows_of=None):
        row(name, fn, lib, nbytes, 3 * flops, reps=reps, rows_of=rows_of,
            peak=TF32_FLOPS_PER_S, tf32_products="three")
        first, second = fn(), fn()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        print(f"  {name}: CUDA-core fp32 bound {bound(nbytes, flops, FP32_FLOPS_PER_S)[0]:.4f} "
              f"ms; a repeat bit-equal {same}", flush=True)
        if not same:
            fail(f"{name}: two runs on the same inputs differ")

    forward_row("flash_attention_f32",
                lambda impl="auto": flash_attention(q, k, v, bias, True, impl=impl),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                       enable_gqa=True),
                (H + 2 * HKV) * real * HD * 4 + q.numel() * 4 + bias.numel() * 4, flops)
    # K1, row 8: the training shape, right padding, with the lse
    real_rows = torch.ones((B, T), dtype=torch.bool, device="cuda")
    real_rows[0, T - PAD:] = False
    tbias = torch.where(real_rows, 0.0, -1e30).float()
    fwd = lambda impl="auto": fb.flash_attention_fwd_res(q, k, v, tbias, causal=True, impl=impl)
    (o, lse), (o_ref, lse_ref) = fwd(), fwd("plain")
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  flash_attention_fwd_res (fp32) lse: max_abs_err={lse_err:.2e} (tol {LSE_TOL})",
          flush=True)
    if not lse_err <= LSE_TOL:
        fail("flash_attention_fwd_res (fp32): lse disagrees with its plain version")
    tmask = torch.where(causal[None, None], tbias[:, None, None, :],
                        torch.tensor(-1e30, device="cuda"))
    stats = H * real * 4
    forward_row("flash_attention_fwd_res_f32", lambda impl="auto": fwd(impl)[0],
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=tmask,
                                                       enable_gqa=True),
                (H + 2 * HKV) * real * HD * 4 + H * real * HD * 4 + stats + tbias.numel() * 4,
                flops)
    lse_again = fwd()[1]
    torch.cuda.synchronize()
    if not torch.equal(lse, lse_again):
        fail("flash_attention_fwd_res (fp32): two runs give another lse")
    # K4, rows 9-10 on the forward's own residuals
    do = randn(B, H, T, HD) * real_rows[:, None, :, None]
    delta = fb.flash_attention_bwd_delta(o, do)
    if not torch.allclose(delta, fb.flash_attention_bwd_delta(o, do, impl="plain"),
                          rtol=1e-5, atol=1e-5):
        fail("flash_attention_bwd_delta (fp32) disagrees with its plain version")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=tmask, enable_gqa=True)
    lib_bwd = lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
    args = (q, k, v, tbias, do, lse, delta)
    product = 2 * H * HD * visible
    io = lambda heads: heads * real * HD * 4
    grads_in = io(2 * H + 2 * HKV) + 2 * stats + tbias.numel() * 4
    # three TF32 products for each product (both operands split)
    r, dq = row("flash_attention_bwd_dq_f32", lambda impl="auto": fb.flash_attention_bwd_dq(
        *args, causal=True, impl=impl), lib_bwd, grads_in + io(H), 9 * product, reps=5,
        peak=TF32_FLOPS_PER_S, tf32_products="three")
    core = bound(grads_in + io(H), 3 * product, FP32_FLOPS_PER_S)[0]
    r2, dkv = row("flash_attention_bwd_dkv_f32", lambda impl="auto": fb.flash_attention_bwd_dkv(
        *args, causal=True, impl=impl), lib_bwd, grads_in + io(2 * HKV), 12 * product, reps=5,
        peak=TF32_FLOPS_PER_S, tf32_products="three")
    core2 = bound(grads_in + io(2 * HKV), 4 * product, FP32_FLOPS_PER_S)[0]
    print(f"  flash_attention_bwd_dq_f32 + dkv_f32: {r['ms'] + r2['ms']:.4f} ms against SDPA "
          f"fp32's backward {r['library_ms']:.4f} ms; CUDA-core fp32 bounds {core:.4f} / "
          f"{core2:.4f} ms", flush=True)
    again = fb.flash_attention_bwd(q, k, v, tbias, o, lse, do, causal=True)
    if not all(torch.equal(a, b) for a, b in zip(dq + dkv, again)):
        fail("flash_attention_bwd (fp32): two runs on the same inputs differ")
    del q, k, v, o, lse, o_ref, lse_ref, do, delta, leaves, lib_out, lib_mask, tmask, dq, dkv

    # K1, row 2: the ViT chunk, column slices of an fp32 fused QKV
    B, P, D, NH, TQ = 16, 592, 1024, 16, 577
    qkv = randn(B, P, 3 * D)
    q, k, v = qkv.split(D, dim=-1)
    heads = lambda x: x.view(B, P, NH, D // NH).transpose(1, 2)
    key_mask = (torch.arange(P, device="cuda") < TQ)[None, None, None, :]
    forward_row("vit_attention_btd_f32",
                lambda impl="auto": vit_attention_btd(q, k, v, TQ, NH, impl=impl),
                lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                       attn_mask=key_mask),
                4 * B * TQ * D * 4, 4 * B * NH * TQ * TQ * (D // NH), reps=20,
                rows_of=lambda x: x[:, :TQ])
    del qkv, q, k, v

    # K2, rows 3 and 3b: one layer's stripe, half the slots masked; B = 4 the
    # row, B = 32 printed, also with serving masks (left padding, a visible
    # prefix, masked future slots)
    H, NKV, HD, S = 32, 8, 128, 2304
    for B, mask in ((4, "random"), (32, "random"), (32, "serving")):
        q = randn(B, H, 1, HD)
        kf, vf = randn(B, NKV, S, HD), randn(B, NKV, S, HD)
        bias = mask_bias(g, B, mask, S)
        n_vis = int((bias == 0).sum().item())
        ops = 4 * H * n_vis * HD
        lm = bias[:, None, None, :]
        at = f"at B = {B}" + f", {mask} masks" * (mask != "random")
        row("decode_attention_f32", lambda impl="auto": decode_attention(q, kf, vf, bias,
                                                                         impl=impl),
            lambda: F.scaled_dot_product_attention(q, kf, vf, attn_mask=lm, enable_gqa=True),
            2 * q.numel() * 4 + 2 * n_vis * NKV * HD * 4 + bias.numel() * 4, ops,
            keep=B == 4, label=f"decode_attention_f32 {at}",
            rows_of=lambda x: x[(bias > -1e29).any(-1)])
        stripe = {}
        for vals, scales, x in (("kq", "ks", kf), ("vq", "vs", vf)):
            stripe[vals], stripe[scales] = _quantize_kv(x.to(torch.bfloat16))
        kd = (stripe["kq"].float() * stripe["ks"].float().transpose(-1, -2))
        vd = (stripe["vq"].float() * stripe["vs"].float().transpose(-1, -2))
        del kf, vf
        for mode in INT8_MODES:
            name = f"decode_attention_int8_{mode}_f32"
            row(name, lambda impl="auto": decode_attention(q, stripe, None, bias, mode=mode,
                                                           impl=impl),
                lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=lm, enable_gqa=True),
                2 * q.numel() * 4 + 2 * n_vis * NKV * (HD + 2) + bias.numel() * 4, ops,
                keep=B == 4, label=f"{name} {at}")
        del q, stripe, kd, vd, bias, lm

    # K3, rows 4-7: layer 17 of 32 of the four weights of a fused layer (the
    # row: their sum), x fp32; the int8 lm_head at M = 2
    L, LI = 32, 17
    timed = {n: [] for n in ("quant_matmul_stacked_f32", "quant_matmul_p4_f32",
                             "quant_matmul_p4_grouped_f32", "quant_matmul_stacked_f32_tiled",
                             "quant_matmul_p4_f32_tiled", "quant_matmul_p4_grouped_f32_tiled")}
    at8 = {n: [] for n in ("quant_matmul_f32", "quant_matmul_stacked_f32", "quant_matmul_p4_f32",
                           "quant_matmul_p4_grouped_f32")}  # the split rows at M = 8

    def mm(name, fn, w, x, qbytes, reps=20):
        """Both forms run two TF32 products on x split into hi + lo: the bound
        counts them at 495 TFLOP/s (the CUDA-core bound printed beside); the
        split form (M <= 8) also repeats bit for bit."""
        M, K = x.shape
        N = w.shape[1]
        r, (out,) = row(name, fn, lambda: torch.matmul(x, w), x.numel() * 4 + qbytes
                        + M * N * 4, 2 * 2 * M * K * N, reps=reps, keep=False,
                        label=f"{name} x [{M}, {K}] -> [{M}, {N}]", peak=TF32_FLOPS_PER_S)
        r["cuda_core_bound"] = bound(x.numel() * 4 + qbytes + M * N * 4, 2 * M * K * N,
                                     FP32_FLOPS_PER_S)[0]
        if M <= 8:
            again = fn()
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"{name} x [{M}, {K}]: two runs on the same inputs differ")
        return r

    q8 = torch.randint(-127, 128, (4096, 32000), generator=g, device="cuda", dtype=torch.int8)
    s8 = (torch.rand((32000,), generator=g, device="cuda") * 4e-4 + 1e-4).to(torch.bfloat16)
    x2, x8 = randn(2, 4096), randn(8, 4096)
    rows["quant_matmul_f32"] = mm("quant_matmul_f32", lambda impl="auto": qmm.quant_matmul(
        x2, q8, s8, out_dtype=torch.float32, impl=impl), q8.float() * s8.float(), x2,
        q8.numel() + s8.numel() * 2)
    at8["quant_matmul_f32"].append(mm("quant_matmul_f32", lambda impl="auto": qmm.quant_matmul(
        x8, q8, s8, out_dtype=torch.float32, impl=impl), q8.float() * s8.float(), x8,
        q8.numel() + s8.numel() * 2))
    xr = randn(37, 1000)
    qr = torch.randint(-127, 128, (1000, 1100), generator=g, device="cuda", dtype=torch.int8)
    sr = (torch.rand((1100,), generator=g, device="cuda") * 4e-4 + 1e-4).to(torch.bfloat16)
    out, ref = (qmm.quant_matmul(xr, qr, sr, out_dtype=torch.float32, impl=i)
                for i in ("auto", "plain"))
    unit = ref.abs().max()
    tiled = compare("quant_matmul_f32", out / unit, ref / unit)
    print(f"  quant_matmul_f32 tiled form, x [37, 1000] (untimed): max_err/max|ref|="
          f"{tiled['err']:.3g} rel_norm_err={tiled['rel_norm']:.3g}", flush=True)
    if not (tiled["excess"] <= 0 and tiled["rel_norm"] <= FP32_REL_NORM_TOL):
        fail("quant_matmul_f32 (tiled form): kernel disagrees with its plain version")
    rows["quant_matmul_f32"].update({k: max(rows["quant_matmul_f32"][k], tiled[k] * (
        float(unit) if k == "err" else 1)) for k in ("err", "excess", "rel_norm")})
    del q8, s8, qr, sr
    for K, N, _ in P4_SHAPES:
        x2, x8, xp = randn(2, K), randn(8, K), randn(PREFILL_M, K)
        q8 = torch.randint(-127, 128, (L, K, N), generator=g, device="cuda", dtype=torch.int8)
        s8 = (torch.rand((L, N), generator=g, device="cuda") * 4e-4 + 1e-4).to(torch.bfloat16)
        w8 = q8[LI].float() * s8[LI].float()
        for x, name, reps in ((x2, "quant_matmul_stacked_f32", 20),
                              (x8, "quant_matmul_stacked_f32", 20),
                              (xp, "quant_matmul_stacked_f32_tiled", 3)):
            (at8 if x is x8 else timed)[name].append(mm(name, lambda impl="auto": (
                qmm.quant_matmul_stacked(x, q8, s8, LI, out_dtype=torch.float32, impl=impl)),
                w8, x, K * N + N * 2, reps))
        del q8, s8, w8
        for grouped in (False, True):
            qp = torch.randint(-128, 128, (L, K // 2, N), generator=g, device="cuda",
                               dtype=torch.int8)
            sp = (torch.rand((L, K // 128 if grouped else 1, N), generator=g, device="cuda")
                  * 4e-3 + 1e-3).to(torch.bfloat16)
            w = dequantize({"qp": qp[LI], "s": sp[LI]}, torch.float32)
            entry = qmm.quant_matmul_p4_grouped_stacked if grouped else qmm.quant_matmul_p4_stacked
            base = "quant_matmul_p4_grouped_f32" if grouped else "quant_matmul_p4_f32"
            qbytes = K * N // 2 + sp[LI].numel() * 2
            for x, name, reps in ((x2, base, 20), (x8, base, 20), (xp, base + "_tiled", 3)):
                (at8 if x is x8 else timed)[name].append(mm(name, lambda impl="auto": entry(
                    x, qp, sp, LI, out_dtype=torch.float32, impl=impl), w, x, qbytes, reps))
            del qp, sp, w
        del x2, x8, xp
    for name, parts in timed.items():
        r = merge(parts)
        if name != "quant_matmul_stacked_f32_tiled":  # launched by no path: printed only
            rows[name] = r
        core = sum(p.get("cuda_core_bound", 0.0) for p in parts)
        print(f"  {name}, the four shapes together: ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms="
              f"{r['bound'][0]:.4f} ({r['bound'][1]}); CUDA-core fp32 bound {core:.4f} ms",
              flush=True)
    for name, parts in at8.items():  # printed beside the rows (M = 2), not in them
        r = merge(parts)
        print(f"  {name} at M = 8{', the four shapes together' * (len(parts) > 1)}: "
              f"ms={r['ms']:.4f} (M = 2: {rows[name]['ms']:.4f}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}) max_abs_err={r['err']:.3g} rel_norm_err={r['rel_norm']:.3g}",
              flush=True)


def query_offset_checks(torch) -> None:
    """Row 1 with a query offset (a chunk of a chunked prefill over a cache
    stripe, ``flash_attention(..., q_offset=)``), bf16 and fp32, against
    the plain chunked attention (``xla_attention`` with the offset, and the
    JAX package's einsum expression ``grouped_attention`` with the
    [B, 1, T, S] visibility of ``model/mistral.py``): a 512-query chunk at
    slot 1536 of a [2, 8, 2304, 128] stripe whose row 0 is left-padded by
    300 slots, 32 query heads, the stripe read in place."""
    from trace_tpu_torch.kernels.decode_attention import grouped_attention
    from trace_tpu_torch.kernels.flash_attention import NEG_INF, flash_attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, H, HKV, S, HD, T, OFF, PAD = 2, 32, 8, 2304, 128, 512, 1536, 300
    for dtype, name in ((torch.bfloat16, "flash_attention"),
                        (torch.float32, "flash_attention_f32")):
        q = torch.randn((B, H, T, HD), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, HKV, S, HD), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, HKV, S, HD), generator=g, device="cuda").to(dtype)
        vis = torch.zeros((B, S), dtype=torch.bool, device="cuda")
        vis[:, :OFF + T] = True
        vis[0, :PAD] = False
        bias = torch.where(vis, 0.0, NEG_INF).float().contiguous()
        out = flash_attention(q, k, v, bias, True, q_offset=OFF)
        ref = flash_attention(q, k, v, bias, True, q_offset=OFF, impl="plain")
        slot = torch.arange(S, device="cuda")
        upto = OFF + torch.arange(T, device="cuda")[:, None]
        full = (vis[:, None, :] & (slot <= upto)[None])[:, None]
        einsum = grouped_attention(q, k, v, torch.where(full, 0.0, NEG_INF))
        torch.cuda.synchronize()
        norm = NORM_TOL.get(name, REL_NORM_TOL)
        for label, r in (("plain", compare(name, out, ref)),
                         ("einsum", compare(name, out, einsum))):
            print(f"  {name} with query offset {OFF} (T = {T} over S = {S}) against the "
                  f"{label} chunked attention: max_abs_err={r['err']:.3g} excess="
                  f"{r['excess']:.3g} rel_norm_err={r['rel_norm']:.3g} (tol {norm})", flush=True)
            if not (torch.isfinite(out).all() and r["excess"] <= 0 and r["rel_norm"] <= norm):
                fail(f"{name} with a query offset disagrees with the {label} chunked attention")
        del q, k, v, out, ref, einsum


# open_llama_3b's attention (32 / 32 heads, hd 100) at the phase's shapes
HD_HEADS, HD_OTHER = 32, 100


def held_at(torch, name, hd, out, ref, f32, unit=False) -> dict:
    """A row at head dim ``hd`` against its plain version (``out`` and
    ``ref`` a tensor or a tuple of them; ``unit``: in units of max |ref|),
    held to the row's limits: the comparison, the worst over the tuple."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    parts = []
    for a, b in zip(outs, refs):
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite output")
        scale = b.float().abs().max() if unit else 1.0
        r = compare(name, a.float() / scale, b.float() / scale)
        r["err"] *= float(scale)
        parts.append(r)
    r = {k: max(p[k] for p in parts) for k in ("err", "excess", "rel_norm")}
    r["ref_rms"] = parts[0]["ref_rms"]
    norm = FP32_REL_NORM_TOL if f32 else REL_NORM_TOL
    if not (r["excess"] <= 0 and r["rel_norm"] <= norm):
        fail(f"{name} at hd {hd}: kernel disagrees with its plain version")
    return r


def pad_copies_ms(torch, xs, out, hd, width) -> float:
    """ms of a row's pad copies alone, as its wrapper makes them: ``xs``
    padded to ``width``, the padded output ``out`` sliced back to ``hd``."""
    from trace_tpu_torch.kernels.flash_attention import pad_head_dim

    return median_ms(torch, lambda: [pad_head_dim(x, width) for x in xs]
                     + [out[..., :hd].contiguous()])


def pad_share(r, ms) -> str:
    return f"; pad copies {ms:.4f} ms ({100 * ms / r['ms']:.1f} % of the row)"


def row_line(name, hd, r, extra="") -> None:
    print(f"  {name} at hd {hd}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
          f"({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} %) "
          f"max_abs_err={r['err']:.6g} (excess {r['excess']:.6g}) "
          f"rel_norm_err={r['rel_norm']:.6g}{extra}", flush=True)


def head_dim_checks(torch, rows: dict) -> None:
    """Every attention row at open_llama_3b's head dim 100 beside the same
    row at hd 128 and the same heads (32 / 32, G = 1), bf16 and fp32: row 1
    (prefill: q / k / v [2, 32, 2048, hd], causal, row 0 left-padded by 300),
    rows 8, 9 and 10 (the training shape: the same, row 0 right-padded by
    300, do zero on padded rows, the backward from the kernel's residuals),
    row 2 (a 16-frame ViT chunk [16, 592, 16 x hd] of fused-QKV slices, tq
    577) and rows 3 / 3b (q [4, 32, 1, hd] over a [4, 32, 2304, hd] stripe
    read in place, half the slots masked; int8 both modes). Each with its
    bound for hd 100's own bytes and operations (fp32: three TF32 products
    on the attention rows), its plain version and SDPA; the attention rows
    with the time of their pad copies (q, k, v and, backward, do zero-padded
    to 128, the outputs sliced back) and its share of the row's time; the
    decode rows with their launches a call (one: no copy of the cache). The
    bf16 rows of the path (1, 8-10, 3, 3b) are entries ``*_hd100``, which
    phase 9's open_llama_3b path launches; row 2 and the fp32 forms, which
    no path launches at hd 100, are printed and held here."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import (
        flash_attention,
        pad_head_dim,
        pad_heads,
        unpad_heads,
        vit_attention_btd,
    )
    from trace_tpu_torch.model.mistral import _quantize_kv

    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    H, T, PAD, W = HD_HEADS, 2048, 300, 128

    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        sfx = "_f32" if f32 else ""
        peak, mult = (TF32_FLOPS_PER_S, 3) if f32 else (BF16_FLOPS_PER_S, 1)
        esize = 4 if f32 else 2
        randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
        for hd in (W, HD_OTHER):
            # row 1: the prefill
            q, k, v = randn(2, H, T, hd), randn(2, H, T, hd), randn(2, H, T, hd)
            bias = torch.zeros((2, T), device="cuda")
            bias[0, :PAD] = -1e30
            run = lambda impl="auto": flash_attention(q, k, v, bias, True, impl=impl)
            name = f"flash_attention{sfx}"
            r = held_at(torch, name, hd, run(), run("plain"), f32)
            causal_mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
            lib_mask = torch.where(causal_mask[None, None], bias[:, None, None, :],
                                   torch.tensor(-1e30, device="cuda")).to(dtype)
            visible = sum((T - p) * (T - p + 1) // 2 for p in (PAD, 0))
            real = 2 * T - PAD
            r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                     library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
                         q, k, v, attn_mask=lib_mask)),
                     bound=bound(3 * H * real * hd * esize + q.numel() * esize + 2 * T * 4,
                                 mult * 4 * H * hd * visible, peak))
            extra = ""
            if hd != W:
                out = torch.empty_like(pad_head_dim(q, W))
                extra = pad_share(r, pad_copies_ms(torch, (q, k, v), out, hd, W))
                if not f32:
                    rows["flash_attention_hd100"] = r
            row_line(name, hd, r, extra)
            del q, k, v, lib_mask, causal_mask

            # rows 8, 9, 10: the training shape, right padding
            q, k, v, do = (randn(2, H, T, hd) for _ in range(4))
            real_q = torch.ones((2, T), dtype=torch.bool, device="cuda")
            real_q[0, T - PAD:] = False
            bias = torch.where(real_q, 0.0, -1e30).float()
            do = do * real_q[:, None, :, None]
            fwd = lambda impl="auto": fb.flash_attention_fwd_res(q, k, v, bias, causal=True,
                                                                 impl=impl)
            (o, lse), (o_ref, lse_ref) = fwd(), fwd("plain")
            name = f"flash_attention_fwd_res{sfx}"
            r = held_at(torch, name, hd, o, o_ref, f32)
            lse_err = (lse - lse_ref).abs().max().item()
            if not lse_err <= LSE_TOL:
                fail(f"{name} at hd {hd}: lse off by {lse_err:.3g}")
            product = 2 * H * hd * visible
            io = lambda heads: heads * real * hd * esize
            stats = H * real * 4
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            causal_mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
            lib_mask = torch.where(causal_mask[None, None], bias[:, None, None, :],
                                   torch.tensor(-1e30, device="cuda")).to(dtype)
            lib_fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask)
            with torch.no_grad():
                lib_fwd_ms = median_ms(torch, lib_fwd)
            lib_out = lib_fwd()
            lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True))
            r.update(ms=median_ms(torch, fwd), plain_ms=median_ms(torch, lambda: fwd("plain")),
                     library_ms=lib_fwd_ms,
                     bound=bound(io(3 * H) + io(H) + stats + bias.numel() * 4,
                                 mult * 2 * product, peak))
            extra = ""
            if hd != W:
                out = torch.empty_like(pad_head_dim(q, W))
                extra = pad_share(r, pad_copies_ms(torch, (q, k, v), out, hd, W))
                if not f32:
                    rows["flash_attention_fwd_res_hd100"] = r
            row_line(name, hd, r, f"; lse max_abs_err={lse_err:.2e}{extra}")
            del lib_out, leaves, o_ref, lse_ref
            delta = fb.flash_attention_bwd_delta(o, do)
            args = (q, k, v, bias, do, lse, delta)
            for name, fn, n_products, out_heads in (
                    (f"flash_attention_bwd_dq{sfx}", fb.flash_attention_bwd_dq, 3, H),
                    (f"flash_attention_bwd_dkv{sfx}", fb.flash_attention_bwd_dkv, 4, 2 * H)):
                run = lambda impl="auto", fn=fn: fn(*args, causal=True, impl=impl)
                r = held_at(torch, name, hd, run(), run("plain"), f32, unit=True)
                r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                         library_ms=lib_bwd_ms,
                         bound=bound(io(4 * H) + 2 * stats + bias.numel() * 4 + io(out_heads),
                                     mult * n_products * product, peak))
                extra = ""
                if hd != W:
                    out = torch.empty((2, out_heads, T, W), dtype=dtype, device="cuda")
                    extra = pad_share(r, pad_copies_ms(torch, (q, k, v, do), out, hd, W))
                    if not f32:
                        rows[f"{name}_hd100"] = r
                row_line(name, hd, r, extra)
            del q, k, v, do, o, lse, delta, args, lib_mask, causal_mask

            # row 2: a ViT chunk of fused-QKV slices, 16 heads
            B2, P, NH, TQ = 16, 592, 16, 577
            qkv = randn(B2, P, 3 * NH * hd)
            q, k, v = qkv.split(NH * hd, dim=-1)
            run = lambda impl="auto": vit_attention_btd(q, k, v, TQ, NH, impl=impl)
            name = f"vit_attention_btd{sfx}"
            r = held_at(torch, name, hd, run()[:, :TQ], run("plain")[:, :TQ], f32)
            heads = lambda x: x.view(B2, P, NH, hd).transpose(1, 2)
            key_mask = (torch.arange(P, device="cuda") < TQ)[None, None, None, :]
            r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                     library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
                         heads(q), heads(k), heads(v), attn_mask=key_mask)),
                     bound=bound(4 * B2 * TQ * NH * hd * esize,
                                 mult * 4 * B2 * NH * TQ * TQ * hd, peak))
            extra = ""
            if hd != W:
                o_pad = torch.empty((B2, P, NH * W), dtype=dtype, device="cuda")
                copy = median_ms(torch, lambda: [pad_heads(x, NH, W) for x in (q, k, v)]
                                 + [unpad_heads(o_pad, NH, hd)])
                extra = pad_share(r, copy) + f"; no path launches it at hd {hd}"
            row_line(name, hd, r, extra)
            del qkv, q, k, v

            # rows 3 and 3b: one layer's stripe read in place
            B3, S = 4, 2304
            q = randn(B3, H, 1, hd)
            kf, vf = randn(B3, H, S, hd), randn(B3, H, S, hd)
            bias = torch.where(torch.rand((B3, S), generator=g, device="cuda") < 0.5,
                               0.0, -1e30).float()
            (kq, ks), (vq, vs) = (_quantize_kv(x.to(torch.bfloat16)) for x in (kf, vf))
            stripe = {"kq": kq, "ks": ks.contiguous(), "vq": vq, "vs": vs.contiguous()}
            kd = (kq.to(dtype) * ks.transpose(-1, -2).to(dtype))
            vd = (vq.to(dtype) * vs.transpose(-1, -2).to(dtype))
            lib_mask = bias[:, None, None, :].to(dtype)
            visible = int((bias == 0).sum().item())
            for kernel in ("bf16", "s8dot", "dequant"):
                if kernel == "bf16":
                    name = f"decode_attention{sfx}"
                    run = lambda impl="auto": decode_attention(q, kf, vf, bias, impl=impl)
                    lib = lambda: F.scaled_dot_product_attention(q, kf, vf, attn_mask=lib_mask)
                    nbytes = (2 * q.numel() + 2 * visible * H * hd) * esize + bias.numel() * 4
                    count = lambda: (decode_attention.launches_f32 if f32
                                     else decode_attention.launches)
                    peak3 = FP32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
                else:
                    name = f"decode_attention_int8_{kernel}{sfx}"
                    run = lambda impl="auto", m=kernel: decode_attention(
                        q, stripe, None, bias, mode=m, impl=impl)
                    lib = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=lib_mask)
                    nbytes = (2 * q.numel() * esize + 2 * visible * H * (hd + 2)
                              + bias.numel() * 4)
                    table = "launches_int8_f32" if f32 else "launches_int8"
                    count = lambda m=kernel, t=table: getattr(decode_attention, t)[m]
                    peak3 = (INT8_OPS_PER_S if kernel == "s8dot" and not f32
                             else FP32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
                n = count()
                out = run()
                torch.cuda.synchronize()
                calls = count() - n
                if calls != 1:
                    fail(f"{name} at hd {hd}: {calls} launches a call, expected 1")
                r = held_at(torch, name, hd, out, run("plain"), f32)
                r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                         library_ms=median_ms(torch, lib),
                         bound=bound(nbytes, 4 * H * visible * hd, peak3))
                if hd != W and not f32:
                    rows[f"{name}_hd100"] = r
                row_line(name, hd, r, "; one launch a call, the stripe read in place"
                     if hd != W else "")
            del q, kf, vf, kq, vq, kd, vd, stripe, lib_mask


# Falcon3-7B's attention (12 / 4 heads, G = 3) at Falcon3's head dim 256 and
# at a head dim between 128 and 256 (run on copies padded to 256)
WIDE_HEADS, WIDE_HD, WIDE_PADDED = (12, 4), 256, 192


def wide_head_dim_checks(torch, rows: dict) -> None:
    """The attention rows at hd 256 and at hd 192 (padded to 256) beside hd
    128, at Falcon3-7B's 12 / 4 heads, bf16: row 1 (prefill: q [2, 12, 2048,
    hd], k / v [2, 4, 2048, hd], causal, row 0 left-padded by 300), row 8
    (the same, right-padded, with its lse), rows 9 and 10 (the backward from
    row 8's residuals, do zero on the padded rows; each repeated bit for bit)
    and rows 3 / 3b (q [4, 12, 1, hd] over a [4, 4, 2304, hd] stripe read in
    place, half the slots masked; int8 both modes), each with its bound for
    its own hd's bytes and operations, its plain version and SDPA (forward,
    or autograd's backward through it); rows 1, 8, 9 and 10 at 192 with the
    time of their pad copies; the decode rows with their launches a call
    (one: no copy of the cache). The hd-256 rows are entries ``*_hd256``,
    which phase 9's Falcon3 path launches; hd 128 and 192 are printed and
    held here."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, pad_head_dim
    from trace_tpu_torch.model.mistral import _quantize_kv

    g = torch.Generator(device="cuda").manual_seed(SEED + 256)
    (H, HKV), T, PAD, W = WIDE_HEADS, 2048, 300, WIDE_HD
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    causal_mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    visible = sum((T - p) * (T - p + 1) // 2 for p in (PAD, 0))  # causal pairs a head
    real = 2 * T - PAD
    print(f"head dims above 128 at Falcon3-7B's {H} / {HKV} heads:", flush=True)
    for hd in (128, WIDE_HD, WIDE_PADDED):
        sfx = f"_hd{hd}" if hd == WIDE_HD else ""
        # rows 1 and 8: the prefill (left padding) and the training shape's
        # forward with its residual (right padding)
        for name, side in (("flash_attention", "left"), ("flash_attention_fwd_res", "right")):
            q, k, v = randn(2, H, T, hd), randn(2, HKV, T, hd), randn(2, HKV, T, hd)
            bias = torch.zeros((2, T), device="cuda")
            if side == "left":
                bias[0, :PAD] = -1e30
            else:
                bias[0, T - PAD:] = -1e30
            if name == "flash_attention":
                run = lambda impl="auto": flash_attention(q, k, v, bias, True, impl=impl)
                r = held_at(torch, name, hd, run(), run("plain"), False)
                extra = ""
            else:
                run = lambda impl="auto": fb.flash_attention_fwd_res(q, k, v, bias, causal=True,
                                                                     impl=impl)
                (o, lse), (o_ref, lse_ref) = run(), run("plain")
                r = held_at(torch, name, hd, o, o_ref, False)
                lse_err = (lse - lse_ref).abs().max().item()
                if not lse_err <= LSE_TOL:
                    fail(f"{name} at hd {hd}: lse off by {lse_err:.3g}")
                extra = f"; lse max_abs_err={lse_err:.2e}"
                del o_ref, lse_ref
            lib_mask = torch.where(causal_mask[None, None], bias[:, None, None, :],
                                   torch.tensor(-1e30, device="cuda")).to(torch.bfloat16)
            stats = H * real * 4 if name == "flash_attention_fwd_res" else 0
            r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                     library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
                         q, k, v, attn_mask=lib_mask, enable_gqa=True)),
                     bound=bound((H + 2 * HKV) * real * hd * 2 + q.numel() * 2 + stats
                                 + bias.numel() * 4, 4 * H * hd * visible))
            if hd == WIDE_PADDED:
                out = torch.empty_like(pad_head_dim(q, W))
                extra += pad_share(r, pad_copies_ms(torch, (q, k, v), out, hd, W))
            if sfx:
                rows[name + sfx] = r
            row_line(name, hd, r, extra)
            if name == "flash_attention_fwd_res":
                wide_backward_rows(torch, rows, q, k, v, bias, o, lse, lib_mask, hd, sfx)
                del o, lse
            del q, k, v, lib_mask

        # rows 3 and 3b: one layer's stripe read in place
        B3, S = 4, 2304
        q = randn(B3, H, 1, hd)
        kf, vf = randn(B3, HKV, S, hd), randn(B3, HKV, S, hd)
        bias = torch.where(torch.rand((B3, S), generator=g, device="cuda") < 0.5,
                           0.0, -1e30).float()
        (kq, ks), (vq, vs) = _quantize_kv(kf), _quantize_kv(vf)
        stripe = {"kq": kq, "ks": ks.contiguous(), "vq": vq, "vs": vs.contiguous()}
        kd = (kq.to(torch.bfloat16) * ks.transpose(-1, -2)).to(torch.bfloat16)
        vd = (vq.to(torch.bfloat16) * vs.transpose(-1, -2)).to(torch.bfloat16)
        lib_mask = bias[:, None, None, :].to(torch.bfloat16)
        seen = int((bias == 0).sum().item())  # (row, slot) pairs
        for kernel in ("bf16", "s8dot", "dequant"):
            if kernel == "bf16":
                name = "decode_attention"
                run = lambda impl="auto": decode_attention(q, kf, vf, bias, impl=impl)
                lib = lambda: F.scaled_dot_product_attention(q, kf, vf, attn_mask=lib_mask,
                                                             enable_gqa=True)
                nbytes = (2 * q.numel() + 2 * seen * HKV * hd) * 2 + bias.numel() * 4
                count = lambda: decode_attention.launches
                peak = BF16_FLOPS_PER_S
            else:
                name = f"decode_attention_int8_{kernel}"
                run = lambda impl="auto", m=kernel: decode_attention(q, stripe, None, bias,
                                                                     mode=m, impl=impl)
                lib = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=lib_mask,
                                                             enable_gqa=True)
                nbytes = 2 * q.numel() * 2 + 2 * seen * HKV * (hd + 2) + bias.numel() * 4
                count = lambda m=kernel: decode_attention.launches_int8[m]
                peak = INT8_OPS_PER_S if kernel == "s8dot" else BF16_FLOPS_PER_S
            n = count()
            out = run()
            torch.cuda.synchronize()
            if count() - n != 1:
                fail(f"{name} at hd {hd}: {count() - n} launches a call, expected 1")
            r = held_at(torch, name, hd, out, run("plain"), False)
            if not torch.equal(out, run()):
                fail(f"{name} at hd {hd}: a repeat differs from the first call")
            r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                     library_ms=median_ms(torch, lib),
                     bound=bound(nbytes, 4 * H * seen * hd, peak))
            if sfx:
                rows[name + sfx] = r
            row_line(name, hd, r, "; one launch a call, the stripe read in place, repeated "
                     "bit for bit")
        del q, kf, vf, kq, vq, kd, vd, stripe, lib_mask


def wide_backward_rows(torch, rows, q, k, v, bias, o, lse, lib_mask, hd, sfx) -> None:
    """Rows 9 and 10 of ``wide_head_dim_checks``: the backward from row 8's
    residuals ``o`` and ``lse`` with a do zero on the padded rows (bias <
    0), held to the plain versions in units of max |ref| and repeated bit
    for bit; bound for the visible pairs (3 products for dq, 4 for dk/dv)
    and the bytes of q, k, v, do, lse, delta, the bias and the outputs;
    library: autograd's backward through SDPA with the same mask; at hd 192
    the pad copies (q, k, v, do in, the output sliced back)."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels import flash_backward as fb

    (B, H, T, _), HKV = q.shape, k.shape[1]
    g = torch.Generator(device="cuda").manual_seed(SEED + hd)
    do = (torch.randn(q.shape, generator=g, device="cuda")
          * (bias == 0)[:, None, :, None]).to(torch.bfloat16)
    real = int((bias == 0).sum().item())  # (batch row, token) pairs that are real
    visible = sum(n * (n + 1) // 2 for n in (bias == 0).sum(dim=1).tolist())
    delta = fb.flash_attention_bwd_delta(o, do)
    args = (q, k, v, bias, do, lse, delta)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask, enable_gqa=True)
    lib_ms = median_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, do,
                                                          retain_graph=True))
    del lib_out, leaves
    product = 2 * H * hd * visible
    inputs = (2 * H + 2 * HKV) * real * hd * 2 + 2 * H * real * 4 + bias.numel() * 4
    for name, fn, n_products, out_heads in (
            ("flash_attention_bwd_dq", fb.flash_attention_bwd_dq, 3, H),
            ("flash_attention_bwd_dkv", fb.flash_attention_bwd_dkv, 4, 2 * HKV)):
        run = lambda impl="auto", fn=fn: fn(*args, causal=True, impl=impl)
        out = run()
        r = held_at(torch, name, hd, out, run("plain"), False, unit=True)
        again = run()
        if not all(torch.equal(a, b) for a, b in zip(
                *((x if isinstance(x, tuple) else (x,)) for x in (out, again)))):
            fail(f"{name} at hd {hd}: a repeat differs from the first call")
        del out, again
        r.update(ms=median_ms(torch, run), plain_ms=median_ms(torch, lambda: run("plain")),
                 library_ms=lib_ms,
                 bound=bound(inputs + out_heads * real * hd * 2, n_products * product))
        extra = "; repeated bit for bit"
        if hd == WIDE_PADDED:
            padded = torch.empty((B, out_heads, T, WIDE_HD), dtype=q.dtype, device="cuda")
            extra += pad_share(r, pad_copies_ms(torch, (q, k, v, do), padded, hd, WIDE_HD))
            del padded
        if sfx:
            rows[name + sfx] = r
        row_line(name, hd, r, extra)


def bf16_decode_batch_checks(torch) -> None:
    """bf16 decode attention at B = 32, the bench's decode batch, S = 2304,
    one [B, 8, S, 128] stripe per mask: half the slots masked at random, and
    serving-shaped masks (row b sees slots [pad, end): its left-padded
    prompt, then no future slot). Printed on lines of their own beside the
    bound and SDPA, held to the row's limits; inputs from a generator of
    their own, so that the entries after them see the inputs they saw."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.decode_int8_turns import mask_bias

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, H, NKV, S, HD = 32, 32, 8, 2304, 128  # mask_bias's S
    name = "decode_attention"
    atol, rtol = KERNEL_TOL[name]
    for mask in ("random", "serving"):
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                   for shape in ((B, H, 1, HD), (B, NKV, S, HD), (B, NKV, S, HD)))
        bias = mask_bias(g, B, mask)
        run = lambda impl="auto": decode_attention(q, k, v, bias, impl=impl)
        out, ref = run(), run("plain")
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"{name} at B = {B}, {mask} mask: non-finite output")
        lib_mask = bias[:, None, None, :].to(torch.bfloat16)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                     enable_gqa=True)
        n_visible = int((bias == 0).sum().item())
        flops = 4 * H * n_visible * HD
        nbytes = (2 * q.numel() + 2 * n_visible * NKV * HD) * 2 + bias.numel() * 4
        r = dict(**compare(name, out, ref), ms=median_ms(torch, run),
                 plain_ms=median_ms(torch, lambda: run("plain")),
                 library_ms=median_ms(torch, lib), bound=bound(nbytes, flops))
        print(f"  {name} at B = {B}, S = {S}, {mask} mask: ms={r['ms']:.4f} library_ms="
              f"{r['library_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
              f"{r['bound'][0]:.4f} ({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} %) "
              f"max_abs_err={r['err']:.6f} (|diff| <= {atol} + {rtol} |ref|, excess "
              f"{r['excess']:.6f}) rel_norm_err={r['rel_norm']:.6f}", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL):
            fail(f"{name} at B = {B}, {mask} mask: kernel disagrees with its plain version")
        del q, k, v, bias, out, ref, lib_mask


def merge(parts: list) -> dict:
    """One row out of several timed shapes: errors at their worst, times and
    bounds summed (the row then stands for the shapes together)."""
    worst = {k: max(p[k] for p in parts) for k in ("err", "excess", "rel_norm")}
    total = {k: sum(p[k] for p in parts) for k in ("ms", "plain_ms", "library_ms")}
    by = max(parts, key=lambda p: p["bound"][0])["bound"][1]
    return {**worst, **total, "ref_rms": parts[0]["ref_rms"],
            "bound": (sum(p["bound"][0] for p in parts), by)}


def quant_matmul_checks(torch, g, rows: dict) -> None:
    """The int8 weight product against its plain version in both forms: up
    to 8 rows of x (rows ``quant_matmul`` and ``quant_matmul_stacked``, at
    M = 2) and the wide tile (``quant_matmul_wide`` and
    ``quant_matmul_stacked_wide``, at M = 32, phase 5's decode batch). The
    2-D entry on the lm_head (timed) and at a ragged shape (untimed, its
    errors folded into the row); the stacked entry on layer 17 of 32 of the
    four weights of a fused decoder layer (the row is their sum: one layer's
    weight products of a decode step)."""
    from trace_tpu_torch.kernels.quant_matmul import quant_matmul, quant_matmul_stacked

    def weight(*shape):
        q = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
        s = (torch.rand(shape[:-2] + shape[-1:], generator=g, device="cuda")
             * 4e-4 + 1e-4).to(torch.bfloat16)
        return q, s

    def one(name, fn, x, q2, s1, timed=True):
        """fn(impl) -> y; q2 [K, N], s1 [N] the layer the call reads."""
        out, ref = fn("auto"), fn("plain")
        torch.cuda.synchronize()
        unit = ref.abs().max()
        r = compare(name, out.float() / unit, ref.float() / unit)
        r["err"] *= unit.item()
        if not torch.isfinite(out).all():
            fail(f"{name}: non-finite output")
        if not timed:
            return r
        M, (K, N) = x.shape[0], q2.shape
        w = (q2.to(torch.bfloat16) * s1).contiguous()  # yardstick operand only
        nbytes = x.numel() * 2 + K * N + N * 2 + M * N * out.element_size()
        r.update(ms=median_ms(torch, lambda: fn("auto")),
                 plain_ms=median_ms(torch, lambda: fn("plain")),
                 library_ms=median_ms(torch, lambda: torch.matmul(x, w)),
                 bound=bound(nbytes, 2 * M * K * N))
        print(f"  {name} x [{M}, {K}] @ q [{K}, {N}] -> {str(out.dtype).split('.')[-1]}: "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
              f"{r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}, "
              f"{100 * r['bound'][0] / r['ms']:.1f} %)", flush=True)
        return r

    q, s = weight(4096, 32000)
    qr, sr = weight(1000, 1100)
    for name, M, Mr in (("quant_matmul", 2, 7), ("quant_matmul_wide", 32, 37)):
        x = torch.randn((M, 4096), generator=g, device="cuda").to(torch.bfloat16)
        head = one(name, lambda impl: quant_matmul(
            x, q, s, out_dtype=torch.float32, impl=impl), x, q, s)
        xr = torch.randn((Mr, 1000), generator=g, device="cuda").to(torch.bfloat16)
        ragged = one(name, lambda impl: quant_matmul(
            xr, qr, sr, out_dtype=torch.float32, impl=impl), xr, qr, sr, timed=False)
        head.update({k: max(head[k], ragged[k]) for k in ("err", "excess", "rel_norm")})
        rows[name] = head
    del q, s, qr, sr

    L, LI, parts = 32, 17, {"quant_matmul_stacked": [], "quant_matmul_stacked_wide": []}
    for K, N, out_dtype in ((4096, 6144, torch.bfloat16), (4096, 4096, torch.bfloat16),
                            (4096, 28672, torch.float32), (14336, 4096, torch.bfloat16)):
        q, s = weight(L, K, N)
        for name, M in (("quant_matmul_stacked", 2), ("quant_matmul_stacked_wide", 32)):
            xk = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            parts[name].append(one(name, lambda impl: quant_matmul_stacked(
                xk, q, s, LI, out_dtype=out_dtype, impl=impl), xk, q[LI], s[LI]))
        del q, s
    for name, part in parts.items():
        rows[name] = r = merge(part)
        print(f"  {name}, the four shapes together: ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms="
              f"{r['bound'][0]:.4f} ({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} %)",
              flush=True)


def packed_int4_checks(torch, g, rows: dict) -> None:
    """The nibble-packed int4 products against their plain versions on layer
    17 of 32 of the four weights of a fused 7B layer, through the stacked
    entries the decoder calls: per channel and grouped (group 128), each in
    its split-K form at M = 2 (one row each: the four shapes together = one
    layer's weight products of a decode step) and its tensor-core form at
    M = 3886 (grouped: the four shapes = one layer of the prefill; per
    channel, which no serving prefill runs: wqkv only). The 2-D entries are
    held to the stacked ones bit for bit, and to their plain versions at a
    ragged shape. Yardstick: ``torch.matmul`` on the weight dequantized to
    bf16 beforehand."""
    from trace_tpu_torch.kernels import quant_matmul as qmm
    from trace_tpu_torch.model.quantize import dequantize

    L, LI = 32, 17
    entries = {False: (qmm.quant_matmul_p4_stacked, qmm.quant_matmul_p4),
               True: (qmm.quant_matmul_p4_grouped_stacked, qmm.quant_matmul_p4_grouped)}

    def weight(K, N, grouped, layers=L):
        qp = torch.randint(-128, 128, (layers, K // 2, N), generator=g, device="cuda",
                           dtype=torch.int8)
        s = (torch.rand((layers, K // 128 if grouped else 1, N), generator=g, device="cuda")
             * 4e-3 + 1e-3).to(torch.bfloat16)
        return qp, s

    def one(name, x, qp, s, li, out_dtype, grouped, reps=20):
        stacked, flat = entries[grouped]
        fn = lambda impl="auto": stacked(x, qp, s, li, out_dtype=out_dtype, impl=impl)
        out, ref = fn(), fn("plain")
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"{name}: non-finite output")
        unit = ref.abs().max()
        # an fp32 output has no bf16 rounding to flip: relative limit = absolute
        r = compare(name, out.float() / unit, ref.float() / unit,
                    rtol=KERNEL_TOL[name][0] if out_dtype == torch.float32 else None)
        r["err"] *= unit.item()
        s2 = s[li] if grouped else s[li].reshape(-1)
        if not torch.equal(out, flat(x, qp[li], s2, out_dtype=out_dtype)):
            fail(f"{name}: the 2-D entry differs from the stacked one")
        if not reps:
            return r
        M, K, N = x.shape[0], x.shape[1], qp.shape[2]
        w = dequantize({"qp": qp[li], "s": s[li]})  # yardstick operand only
        nbytes = x.numel() * 2 + K * N // 2 + s[li].numel() * 2 + M * N * out.element_size()
        r.update(ms=median_ms(torch, fn, reps), plain_ms=median_ms(torch, lambda: fn("plain"), reps),
                 library_ms=median_ms(torch, lambda: torch.matmul(x, w), reps),
                 bound=bound(nbytes, 2 * M * K * N))
        print(f"  {name} x [{M}, {K}] @ qp [{K // 2}, {N}] -> "
              f"{str(out.dtype).split('.')[-1]}: max_err/max|ref|={r['err'] / unit.item():.2e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]})", flush=True)
        return r

    parts = {name: [] for name in ("quant_matmul_p4", "quant_matmul_p4_grouped",
                                   "quant_matmul_p4_mma", "quant_matmul_p4_grouped_mma")}
    for K, N, dtype_name in P4_SHAPES:
        out_dtype = getattr(torch, dtype_name)
        x2 = torch.randn((2, K), generator=g, device="cuda").to(torch.bfloat16)
        xp = torch.randn((PREFILL_M, K), generator=g, device="cuda").to(torch.bfloat16)
        for grouped in (False, True):
            qp, s = weight(K, N, grouped)
            base = "quant_matmul_p4_grouped" if grouped else "quant_matmul_p4"
            parts[base].append(one(base, x2, qp, s, LI, out_dtype, grouped))
            if grouped or N == 6144:
                parts[base + "_mma"].append(one(base + "_mma", xp, qp, s, LI, out_dtype,
                                                grouped, reps=10))
            if grouped and N == 6144:
                # the 64-row tile at a corpus-serving decode batch of 32 rows:
                # printed, held to the limits, not summed into the row
                print("  (the 64-row tile, M = 32, not in the row:)", flush=True)
                r = one(base + "_mma", xp[:32].contiguous(), qp, s, LI, out_dtype, grouped)
                parts[base + "_mma"].append({k: r[k] for k in ("err", "excess", "rel_norm")})
            del qp, s
    # ragged M, N (and, per channel, K / 2 no multiple of 8), untimed; M = 65
    # and 129 are one row past a 64-row and a 128-row tile
    for grouped, M, K, N in ((False, 3, 1000, 1100), (False, 37, 1000, 1100),
                             (False, 65, 1000, 1100), (False, 129, 1000, 1100),
                             (True, 3, 1024, 1100), (True, 37, 1024, 1100),
                             (True, 65, 1024, 1100), (True, 129, 1024, 1100)):
        xr = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        qp, s = weight(K, N, grouped, layers=2)
        name = ("quant_matmul_p4_grouped" if grouped else "quant_matmul_p4") \
            + ("" if M <= 8 else "_mma")
        parts[name].append(one(name, xr, qp, s, 1, torch.float32, grouped, reps=0))
    for name, ps in parts.items():
        timed = [p for p in ps if "ms" in p]
        rows[name] = merge(timed)
        rows[name].update({k: max(p[k] for p in ps) for k in ("err", "excess", "rel_norm")})


def int8_decode_checks(torch, g, rows: dict) -> None:
    """int8 decode attention, both modes, at the bf16 row's shape: L = 32,
    B = 4, S = 2304, layer 17's stripe, half the slots masked, the stripe
    quantized from random K/V as the decoder quantizes it; then the same at
    B = 32, the bench's decode batch, where the bytes and not one launch's
    latency set the bound; then at B = 32 and phase 5's arena length
    (S = 2048 + CORPUS_BUDGET) with serving-shaped masks (the B = 32 cases
    printed on lines of their own, held to the same limits; the B = 4
    entries are the row)."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels.decode_attention import INT8_MODES, decode_attention
    from trace_tpu_torch.kernels.decode_int8_turns import mask_bias
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.mistral import _quantize_kv, init_kv_cache

    H, NKV, HD, LI = 32, 8, 128, 17
    cfg = DecoderConfig(kv_cache_dtype="int8")
    for B, S, mask in ((4, 2304, "random"), (32, 2304, "random"),
                       (32, 2048 + CORPUS_BUDGET, "serving")):
        cache = init_kv_cache(cfg, B, S, device="cuda")
        stripe = {name: leaf[LI] for name, leaf in cache.items()}
        for vals, scales in (("kq", "ks"), ("vq", "vs")):
            x = torch.randn((B, NKV, S, HD), generator=g, device="cuda").to(torch.bfloat16)
            stripe[vals][:], stripe[scales][:] = _quantize_kv(x)
            del x
        q = torch.randn((B, H, 1, HD), generator=g, device="cuda").to(torch.bfloat16)
        bias = mask_bias(g, B, mask, S)
        # the yardstick's operands: the stripe dequantized to bf16 beforehand
        kd = stripe["kq"].to(torch.bfloat16) * stripe["ks"].transpose(-1, -2)
        vd = stripe["vq"].to(torch.bfloat16) * stripe["vs"].transpose(-1, -2)
        lib_mask = bias[:, None, None, :].to(torch.bfloat16)
        lib = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=lib_mask,
                                                     enable_gqa=True)
        # as for the bf16 row, the visible slots' K and V rows (1 byte a
        # value) and their two scales; both products count as int8 operations
        visible = int((bias == 0).sum().item())
        ops = 4 * (H // NKV) * NKV * visible * HD
        nbytes = 2 * q.numel() * 2 + 2 * visible * NKV * (HD + 2) + bias.numel() * 4
        for mode in INT8_MODES:
            name = f"decode_attention_int8_{mode}"
            run = lambda impl="auto": decode_attention(q, stripe, None, bias, mode=mode,
                                                       impl=impl)
            out, ref = run(), run("plain")
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"{name} at B = {B}, S = {S}: non-finite output")
            r = dict(**compare(name, out, ref), ms=median_ms(torch, run),
                     plain_ms=median_ms(torch, lambda: run("plain")),
                     library_ms=median_ms(torch, lib),
                     bound=bound(nbytes, ops,
                                 INT8_OPS_PER_S if mode == "s8dot" else BF16_FLOPS_PER_S))
            if B == 4:
                rows[name] = r
                continue
            atol, rtol = KERNEL_TOL[name]
            print(f"  {name} at B = {B}, S = {S}, {mask} mask: ms={r['ms']:.4f} library_ms="
                  f"{r['library_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
                  f"{r['bound'][0]:.4f} ({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} %) "
                  f"max_abs_err={r['err']:.6f} (|diff| <= {atol} + {rtol} |ref|, excess "
                  f"{r['excess']:.6f}) rel_norm_err={r['rel_norm']:.6f}", flush=True)
            if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL):
                fail(f"{name} at B = {B}, S = {S}, {mask} mask: kernel disagrees with "
                     "its plain version")
        del cache, stripe, kd, vd, q, bias, lib_mask


def group_decode_checks(torch, rows: dict) -> None:
    """Rows 3 and 3b at qwen2-7B's heads, 28 query heads over 4 kv heads
    (G = 7): q [4, 28, 1, 128] over one layer's stripe [4, 4, 2304, 128],
    half the slots masked, bf16 and int8 (both modes; the stripe quantized
    from random K / V as the decoder quantizes it), the entries
    ``decode_attention_g7`` and ``decode_attention_int8_{s8dot,dequant}_g7``
    timed beside SDPA with enable_gqa (the int8 stripe dequantized to bf16
    beforehand). Then, printed on lines of their own and held to the same
    limits: the same at B = 32 with serving masks; G = 16 (q [4, 64, 1, 128])
    through the wrapper's split, two launches a call; and the prefill flash
    attention at G = 7, q [2, 28, 2048, 128] over k / v [2, 4, 2048, 128],
    causal, row 0 left-padded by 300 slots. Inputs from a generator of their
    own."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.decode_int8_turns import mask_bias
    from trace_tpu_torch.kernels.flash_attention import flash_attention
    from trace_tpu_torch.model.mistral import _quantize_kv

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    NKV, S, HD = 4, 2304, 128

    def launches(kernel):
        return (decode_attention.launches if kernel == "bf16"
                else decode_attention.launches_int8[kernel])

    for B, G, mask in ((4, 7, "random"), (32, 7, "serving"), (4, 16, "random")):
        H = NKV * G
        q, k, v = randn(B, H, 1, HD), randn(B, NKV, S, HD), randn(B, NKV, S, HD)
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        stripe = {"kq": kq, "ks": ks.contiguous(), "vq": vq, "vs": vs.contiguous()}
        kd = kq.to(torch.bfloat16) * ks.transpose(-1, -2)
        vd = vq.to(torch.bfloat16) * vs.transpose(-1, -2)
        bias = mask_bias(g, B, mask, S)
        lib_mask = bias[:, None, None, :].to(torch.bfloat16)
        visible = int((bias == 0).sum().item())
        ops = 4 * H * visible * HD
        for kernel in ("bf16", "s8dot", "dequant"):
            if kernel == "bf16":
                name = "decode_attention_g7"
                run = lambda impl="auto": decode_attention(q, k, v, bias, impl=impl)
                lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                             enable_gqa=True)
                nbytes = (2 * q.numel() + 2 * visible * NKV * HD) * 2 + bias.numel() * 4
                peak = BF16_FLOPS_PER_S
            else:
                name = f"decode_attention_int8_{kernel}_g7"
                run = lambda impl="auto": decode_attention(q, stripe, None, bias, mode=kernel,
                                                           impl=impl)
                lib = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=lib_mask,
                                                             enable_gqa=True)
                nbytes = 2 * q.numel() * 2 + 2 * visible * NKV * (HD + 2) + bias.numel() * 4
                peak = INT8_OPS_PER_S if kernel == "s8dot" else BF16_FLOPS_PER_S
            n = launches(kernel)
            out = run()
            torch.cuda.synchronize()
            calls = launches(kernel) - n
            ref = run("plain")
            if not torch.isfinite(out).all():
                fail(f"{name} at B = {B}, G = {G}: non-finite output")
            if calls != (G + 7) // 8:
                fail(f"{name} at G = {G}: {calls} launches a call, expected {(G + 7) // 8}")
            r = dict(**compare(name, out, ref), ms=median_ms(torch, run),
                     plain_ms=median_ms(torch, lambda: run("plain")),
                     library_ms=median_ms(torch, lib), bound=bound(nbytes, ops, peak))
            if (B, G) == (4, 7):
                rows[name] = r
                continue
            atol, rtol = KERNEL_TOL[name]
            print(f"  {name.replace('_g7', '')} at B = {B}, G = {G} ({NKV} kv heads), S = {S}, "
                  f"{mask} mask, {calls} launch(es) a call: ms={r['ms']:.4f} library_ms="
                  f"{r['library_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
                  f"{r['bound'][0]:.4f} ({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.1f} %) "
                  f"max_abs_err={r['err']:.6f} (|diff| <= {atol} + {rtol} |ref|, excess "
                  f"{r['excess']:.6f}) rel_norm_err={r['rel_norm']:.6f}", flush=True)
            if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL):
                fail(f"{name} at B = {B}, G = {G}: kernel disagrees with its plain version")
        del q, k, v, stripe, kq, vq, kd, vd, bias, lib_mask

    # the prefill attention at G = 7
    B, H, T, PAD = 2, 28, 2048, 300
    q, k, v = randn(B, H, T, HD), randn(B, NKV, T, HD), randn(B, NKV, T, HD)
    bias = torch.zeros((B, T), device="cuda")
    bias[0, :PAD] = -1e30
    run = lambda impl="auto": flash_attention(q, k, v, bias, True, impl=impl)
    out, ref = run(), run("plain")
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("flash_attention at G = 7: non-finite output")
    cmp = compare("flash_attention", torch.cat([out[0, :, PAD:], out[1]], dim=1),
                  torch.cat([ref[0, :, PAD:], ref[1]], dim=1))
    atol, rtol = KERNEL_TOL["flash_attention"]
    print(f"  flash_attention at G = 7 (q [{B}, {H}, {T}, {HD}], kv [{B}, {NKV}, {T}, {HD}], "
          f"causal, row 0 left-padded by {PAD}): ms={median_ms(torch, run):.4f} "
          f"max_abs_err={cmp['err']:.6f} (|diff| <= {atol} + {rtol} |ref|, excess "
          f"{cmp['excess']:.6f}) rel_norm_err={cmp['rel_norm']:.6f}", flush=True)
    if not (cmp["excess"] <= 0 and cmp["rel_norm"] <= REL_NORM_TOL):
        fail("flash_attention at G = 7: kernel disagrees with its plain version")


def flash_backward_checks(torch, g, rows: dict) -> None:
    """The training attention at the shape a full-width train step gives it:
    q/do/o [2, 32, 2048, 128], k/v [2, 8, 2048, 128], causal, row 0
    right-padded by 300 slots, do zero on padded query rows. The backward
    kernels read the forward kernel's own residuals, as training does.
    Yardstick: autograd through ``scaled_dot_product_attention`` (forward for
    the forward row; one backward call computes dq, dk and dv together, so
    both backward rows carry its whole time). Bounds count what each function
    needs over the visible pairs of real query rows: the forward 2 products,
    dq 3 (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q); a
    joint backward would need 5."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from trace_tpu_torch.kernels import flash_backward as fb

    B, H, HKV, T, HD, PAD = 2, 32, 8, 2048, 128, 300
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = randn(B, H, T, HD), randn(B, HKV, T, HD), randn(B, HKV, T, HD)
    real = torch.ones((B, T), dtype=torch.bool, device="cuda")
    real[0, T - PAD:] = False
    bias = torch.where(real, 0.0, -1e30).float()
    do = randn(B, H, T, HD) * real[:, None, :, None]

    fwd = lambda impl="auto": fb.flash_attention_fwd_res(q, k, v, bias, causal=True, impl=impl)
    (o, lse), (o_ref, lse_ref) = fwd(), fwd("plain")
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail("flash_attention_fwd_res: non-finite output")
    # every row sees key 0 here (right padding): all rows compare
    cmp = compare("flash_attention_fwd_res", o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  flash_attention_fwd_res lse: max_abs_err={lse_err:.2e} (tol {LSE_TOL})", flush=True)
    if not lse_err <= LSE_TOL:
        fail("flash_attention_fwd_res: lse disagrees with its plain version")
    visible = sum((T - p) * (T - p + 1) // 2 for p in (PAD, 0))  # per head, real query rows
    product = 2 * H * HD * visible  # operations of one product over the visible pairs
    n_real = 2 * T - PAD
    io = lambda heads: heads * n_real * HD * 2  # bf16 rows of real tokens
    stats = H * n_real * 4                       # one fp32 per real query row
    causal_mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    lib_mask = torch.where(causal_mask[None, None], bias[:, None, None, :],
                           torch.tensor(-1e30, device="cuda")).to(torch.bfloat16)
    lib_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    lib_fwd = lambda: F.scaled_dot_product_attention(*lib_leaves, attn_mask=lib_mask,
                                                     enable_gqa=True)
    lib_out = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)
    with torch.no_grad():
        lib_fwd_ms = median_ms(torch, lib_fwd)
    lib_bwd_ms = median_ms(torch, lib_bwd)
    # informational: SDPA's flash backend with is_causal and no bias, what
    # PyTorch's own backward reaches on this shape (not the same function)
    flash_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        flash_out = F.scaled_dot_product_attention(*flash_leaves, is_causal=True,
                                                   enable_gqa=True)
    flash_bwd = lambda: torch.autograd.grad(flash_out, flash_leaves, do, retain_graph=True)
    print(f"  SDPA flash backward, is_causal, no bias: {median_ms(torch, flash_bwd):.4f} ms",
          flush=True)
    del flash_leaves, flash_out, flash_bwd
    rows["flash_attention_fwd_res"] = dict(
        **cmp, ms=median_ms(torch, fwd), plain_ms=median_ms(torch, lambda: fwd("plain")),
        library_ms=lib_fwd_ms,
        bound=bound(io(H + 2 * HKV) + io(H) + stats + bias.numel() * 4, 2 * product))
    rate_line("flash_attention_fwd_res", rows["flash_attention_fwd_res"], 2 * product)
    del o_ref, lse_ref, lib_out, lib_leaves, lib_mask

    delta = fb.flash_attention_bwd_delta(o, do)
    delta_ref = fb.flash_attention_bwd_delta(o, do, impl="plain")
    if not torch.allclose(delta, delta_ref, rtol=1e-5, atol=1e-5):
        fail("flash_attention_bwd_delta disagrees with its plain version")
    args = (q, k, v, bias, do, lse, delta)

    def grad_row(name, fn, n_products, out_heads):
        out, ref = fn("auto"), fn("plain")
        torch.cuda.synchronize()
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        parts = []
        for a, b in zip(out, ref):
            if not torch.isfinite(a).all():
                fail(f"{name}: non-finite output")
            unit = b.float().abs().max()
            r = compare(name, a.float() / unit, b.float() / unit)
            r["err"] *= unit.item()
            parts.append(r)
        worst = {key: max(p[key] for p in parts) for key in ("err", "excess", "rel_norm")}
        # reads q, k, v, do, lse, delta and the bias; writes the gradients
        nbytes = io(2 * H + 2 * HKV) + 2 * stats + bias.numel() * 4 + io(out_heads)
        rows[name] = dict(**worst, ref_rms=parts[0]["ref_rms"], ms=median_ms(torch, lambda: fn("auto")),
                          plain_ms=median_ms(torch, lambda: fn("plain")),
                          library_ms=lib_bwd_ms, bound=bound(nbytes, n_products * product))
        return out

    dq, = grad_row("flash_attention_bwd_dq", lambda impl: fb.flash_attention_bwd_dq(
        *args, causal=True, impl=impl), 3, H)
    dkv = grad_row("flash_attention_bwd_dkv", lambda impl: fb.flash_attention_bwd_dkv(
        *args, causal=True, impl=impl), 4, 2 * HKV)
    # a second run gives the same bits: fixed summation order, no atomics
    again = fb.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=True)
    if not all(torch.equal(a, b) for a, b in zip((dq,) + dkv, again)):
        fail("flash_attention_bwd: two runs on the same inputs differ")
    joint = bound(io(2 * H + 2 * HKV) + io(H) + 2 * stats + bias.numel() * 4
                  + io(H + 2 * HKV), 5 * product)
    whole = rows["flash_attention_bwd_dq"]["ms"] + rows["flash_attention_bwd_dkv"]["ms"]
    print(f"  flash_attention_bwd (delta + dq + dk/dv): dq + dk/dv kernels {whole:.4f} ms, "
          f"delta pre-pass {median_ms(torch, lambda: fb.flash_attention_bwd_delta(o, do)):.4f} ms; "
          f"library backward {lib_bwd_ms:.4f} ms; bound of a joint backward (5 products) "
          f"{joint[0]:.4f} ms ({joint[1]})", flush=True)


def check_head_slices(dec, tokens, initial_head=1):
    """Every generated id lies in the slice of the head that emitted it
    (text [0, V+1), time [V+1, V+1+Vt), score [V+1+Vt, CV)), the heads
    switching on each field's <sync>."""
    from trace_tpu_torch.runtime.generate import PAD_OUTPUT_ID

    v, vt = dec.vocab_size, dec.time_vocab_size
    slices = ((0, v + 1), (v + 1, v + 1 + vt), (v + 1 + vt, dec.combined_vocab_size))
    swaps = {v: 1, v + 1: 2, v + 1 + vt: 0}
    for row in tokens:
        head = initial_head
        for t in row:
            if t == PAD_OUTPUT_ID:
                break
            lo, hi = slices[head]
            if not lo <= t < hi:
                fail(f"token {t} outside head {head}'s slice [{lo}, {hi})")
            head = swaps.get(int(t), head)


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def dequantized_fp32(tree):
    """A quantized serving tree as dense fp32 weights, a layer at a time:
    int8 leaves q * s exactly; packed int4 leaves the flattened [L, K, N]
    weight their product multiplies (nibble * s exactly per channel, that
    product rounded to bf16 with group-wise scales); fused leaves split
    back; other leaves widened to fp32."""
    import torch

    from trace_tpu_torch.model.quantize import (
        dequantize,
        is_packed4,
        is_quantized,
        packed4_groups,
        unfuse_decoder_serving,
        unpack4,
    )

    if "layers" in tree and is_quantized(tree["layers"].get("wqkv")):
        tree = unfuse_decoder_serving(tree)  # the dense ViT's fused wqkv stays
    out = {}
    for name, leaf in tree.items():
        if is_packed4(leaf):
            qp, sc = leaf["qp"], leaf["s"]
            w = torch.empty((qp.shape[0], 2 * qp.shape[1], qp.shape[2]), dtype=torch.float32,
                            device=qp.device)
            for li in range(qp.shape[0]):
                if packed4_groups(leaf) > 1:
                    w[li] = dequantize({"qp": qp[li], "s": sc[li]})
                else:
                    w[li] = unpack4(qp[li]).float() * sc[li].float()
            out[name] = w
        elif is_quantized(leaf):
            q, sc = leaf["q"], leaf["s"]
            w = torch.empty(q.shape, dtype=torch.float32, device=q.device)
            if q.ndim > 2:
                for li in range(q.shape[0]):
                    w[li] = q[li].float() * sc[li].float()
            else:
                w[:] = q.float() * sc.float()
            out[name] = w
        elif isinstance(leaf, dict):
            out[name] = dequantized_fp32(leaf)
        elif isinstance(leaf, list):  # a connector's layers (the STC family)
            out[name] = [dequantized_fp32(x) for x in leaf]
        else:
            out[name] = leaf.float()
    return out


def dequant_request(torch, params, cfg, tok, videos, stamps, asks) -> dict:
    """The int8 path once more with the decode attention's other body
    (``decode_attn_int8="dequant"``), 8 new tokens: its launch count."""
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.runtime.pipeline import TracePipeline

    dcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, decode_attn_int8="dequant"))
    pipe = TracePipeline(params, dcfg, tok)
    before = dict(decode_attention.launches_int8)
    decode_attention.launches_int8["dequant"] = 0
    pipe.infer_events_batch(videos, stamps, asks, max_new_tokens=8)
    got = decode_attention.launches_int8["dequant"]
    steps = pipe.last_stats["decode_steps"]
    print(f"int8 request with decode_attn_int8='dequant': {got} launches over "
          f"{steps} steps (expected {cfg.decoder.num_layers * steps})", flush=True)
    if steps <= 0 or got != cfg.decoder.num_layers * steps:
        fail("dequant decode attention: unexpected launch count")
    if decode_attention.launches_int8["s8dot"] != before["s8dot"]:
        fail("the dequant request launched the s8dot body")
    check_head_slices(cfg.decoder, pipe.last_stats["tokens"])
    return {"decode_attention_int8_dequant": got}


def weight_only_request(torch, params, cfg, tok, videos, stamps, asks) -> dict:
    """The per-channel int4p tree once more without activation quantization,
    8 new tokens: the prefill then goes through the per-channel kernel's
    tensor-core form (four products a layer), the steps through its split-K
    form."""
    from trace_tpu_torch.kernels.quant_matmul import quant_matmul_p4
    from trace_tpu_torch.runtime.pipeline import TracePipeline

    wcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, act_quant=False))
    pipe = TracePipeline(params, wcfg, tok)
    quant_matmul_p4.launches = 0
    quant_matmul_p4.launches_by_form.update(splitk=0, mma=0)
    pipe.infer_events_batch(videos, stamps, asks, max_new_tokens=8)
    got = dict(quant_matmul_p4.launches_by_form)
    steps, L = pipe.last_stats["decode_steps"], cfg.decoder.num_layers
    want = {"splitk": 4 * L * steps, "mma": 4 * L}
    print(f"int4p per-channel request without act_quant: launches {got} over {steps} steps "
          f"(expected {want})", flush=True)
    if steps <= 0 or got != want:
        fail("weight-only per-channel int4p request: unexpected launch counts")
    check_head_slices(cfg.decoder, pipe.last_stats["tokens"])
    return {"quant_matmul_p4_mma": got["mma"]}


G0_LAYERS = 4  # depth of the per-channel (group 0) int4p run
# depth of the group-128 int4p run: its row 7 runs the same shapes at
# every layer, and 32 layers put the whole smoke past 900 s of the 1200; 4
# since the whole smoke took 1073 s at 8 on an H100 80GB HBM3 at 700 W
INT4P_LAYERS = 4
# depth of the bf16 and int8 runs (phase 7 serves the 32-layer checkpoint in
# bf16, int8, int4 and fp32): 32 put the whole smoke past 1000 s with the fp32
# checks; 8 since it took 1165 s at 16 with the hd-256 path of phase 9 (an H100
# 80GB HBM3 at 700 W)
SERVE_LAYERS = 8


def _serving_kernels():
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.kernels import quant_matmul as qm

    return (flash_attention, vit_attention_btd, decode_attention, qm.quant_matmul,
            qm.quant_matmul_stacked, qm.quant_matmul_p4, qm.quant_matmul_p4_grouped)


def reset_serving_launches() -> None:
    """Every launch count of the serving kernels set to 0, the fp32 forms'
    too."""
    fa, vit, da, qmm, qmm_stacked, p4, p4g = _serving_kernels()
    for fn in (fa, vit, da, qmm, qmm_stacked, p4, p4g):
        fn.launches = fn.launches_f32 = 0
    for m in da.launches_int8:
        da.launches_int8[m] = da.launches_int8_f32[m] = 0
    for fn in (p4, p4g):
        fn.launches_by_form.update(splitk=0, mma=0)
    for fn in (qmm, qmm_stacked):
        fn.launches_by_form.update(splitk=0, wide=0)
    for fn in (qmm, qmm_stacked, p4, p4g):
        fn.launches_f32_by_form.update(splitk=0, tiled=0)


def serving_launches() -> dict:
    """The serving kernels' launch counts under their rows' names."""
    fa, vit, da, qmm, qmm_stacked, p4, p4g = _serving_kernels()
    return {"flash_attention": fa.launches,
            "vit_attention_btd": vit.launches,
            "decode_attention": da.launches,
            **int8_product_launches(qmm, qmm_stacked),
            **{f"decode_attention_int8_{m}": n for m, n in da.launches_int8.items()},
            "quant_matmul_p4": p4.launches_by_form["splitk"],
            "quant_matmul_p4_mma": p4.launches_by_form["mma"],
            "quant_matmul_p4_grouped": p4g.launches_by_form["splitk"],
            "quant_matmul_p4_grouped_mma": p4g.launches_by_form["mma"],
            **fp32_serving_launches()}


def fp32_serving_launches() -> dict:
    """The fp32 forms' launch counts of the serving kernels, under their
    rows' names (the int8 products' two forms in one row each)."""
    fa, vit, da, qmm, qmm_stacked, p4, p4g = _serving_kernels()
    return {"flash_attention_f32": fa.launches_f32,
            "vit_attention_btd_f32": vit.launches_f32,
            "decode_attention_f32": da.launches_f32,
            **{f"decode_attention_int8_{m}_f32": n for m, n in da.launches_int8_f32.items()},
            "quant_matmul_f32": qmm.launches_f32,
            "quant_matmul_stacked_f32": qmm_stacked.launches_f32,
            "quant_matmul_p4_f32": p4.launches_f32_by_form["splitk"],
            "quant_matmul_p4_f32_tiled": p4.launches_f32_by_form["tiled"],
            "quant_matmul_p4_grouped_f32": p4g.launches_f32_by_form["splitk"],
            "quant_matmul_p4_grouped_f32_tiled": p4g.launches_f32_by_form["tiled"]}


# what a phase leaves for phase 11: phase 10's padded prefill hidden at its
# first routed layer ("moe_hidden", on the host)
STASH = {}


@contextlib.contextmanager
def recorded_routes(into: list, drops: list, first_input: dict = None):
    """Record, while the block runs, the top-k expert set (sorted indices
    [N, k], on the host) of every call of ``model.moe.route`` into ``into``,
    and the assignments each sparse dispatch drops into ``drops``, in
    order; with ``first_input``, the first routed hidden [N, D] (on the
    host) under its key "moe_hidden" unless it holds one."""
    from trace_tpu_torch.model import moe

    route, dispatch = moe.route, moe.dispatch

    def routed(x2d, router, top_k):
        if first_input is not None and "moe_hidden" not in first_input:
            first_input["moe_hidden"] = x2d.detach().cpu()
        vals, idx = route(x2d, router, top_k)
        into.append(idx.sort(dim=-1).values.cpu())
        return vals, idx

    def dispatched(top_idx, num_experts, cap):
        out = dispatch(top_idx, num_experts, cap)
        drops.append(int((~out[1]).sum()))
        return out

    moe.route, moe.dispatch = routed, dispatched
    try:
        yield into
    finally:
        moe.route, moe.dispatch = route, dispatch


def reference_check(torch, pipe, params, cfg, tok, videos, stamps, asks, mode: str, tokens,
                    profile: bool = True) -> dict:
    """The serving path of ``pipe`` (built from ``params``) against the same path with every kernel
    replaced by its plain version, and against an fp32 reference of the same
    model (plain attention, fp32 weights and activations; for a quantized
    tree the dequantized weights, dense products and an fp32 cache): the
    prefix embeddings and the first-token logits of a prefill, each the
    kernel path no further from the fp32 reference than the plain path is,
    within REF_RATIO_TOL; and the greedy tokens' agreement with the plain
    path's (``tokens``: the kernel path's). With ``profile`` the encode, the
    prefill and a decode step run under torch.profiler. On a Mixtral-family
    decoder, per layer the share of the prefill's real tokens whose top-k
    expert set differs from the fp32 model's, on the kernel and on the plain
    path (reported, not checked), and the assignments a sparse form drops.
    The prefill pads the prefix on the left to a multiple of 128, as the
    pipeline does. Returns the
    distances, the agreement, the routing flips and drops and the
    profiles."""
    from trace_tpu_torch.model.mistral import compute_logits
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.pipeline import TracePipeline

    quantized = cfg.decoder.kv_cache_dtype == "int8"  # int8 / int4p serving
    # The same path with every kernel replaced by its plain version, and an
    # fp32 reference of the same model (plain attention, fp32 weights and
    # activations; for a quantized tree the dequantized weights, dense
    # products and an fp32 cache). With random weights the model is ill-conditioned (the
    # connector's N(0, 1) slots make its softmax over 576 patches nearly an
    # argmax; 32 random decoder layers amplify), so kernel-vs-plain has no
    # fixed scale; the test is that the kernel path is no further from the
    # fp32 reference than the plain path is, within REF_RATIO_TOL.
    plain = TracePipeline(params, cfg, tok, attn_impl="plain")
    if quantized:
        fcfg = dataclasses.replace(
            cfg, dtype=torch.float32,
            decoder=dataclasses.replace(cfg.decoder, kv_cache_dtype="bf16", act_quant=False),
            vision=dataclasses.replace(cfg.vision, act_quant=False))
    else:
        fcfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref_params = dequantized_fp32(pipe.params)
    # pipe.params has dropped decoder.embed: the combined table's text rows
    ref_params["decoder"]["embed"] = pipe._combined[:cfg.decoder.vocab_size].float()
    ref = TracePipeline(ref_params, fcfg, tok, attn_impl="plain")
    del ref_params
    encode_profile = prefill_profile = step_profile = "not measured"
    if profile:
        (prefix, mask), encode_profile = device_profile(
            torch, f"{mode} encode (ViT + connector + splice)",
            lambda: pipe.encode_prefix(videos, stamps, asks))
    else:
        prefix, mask = pipe.encode_prefix(videos, stamps, asks)
    if not torch.isfinite(prefix).all():
        fail("non-finite prefix embeddings")
    prefixes = {"kernel": prefix, "plain": plain.encode_prefix(videos, stamps, asks)[0],
                "fp32": ref.encode_prefix(videos, stamps, asks)[0]}

    P = prefix.shape[1]
    bucket = -(-P // 128) * 128
    pe = torch.nn.functional.pad(prefix, (0, 0, bucket - P, 0))
    pm = torch.nn.functional.pad(mask, (bucket - P, 0))
    logits, routes, drops = {}, {}, {}
    for name, p, impl in (("kernel", pipe, "auto"), ("plain", plain, "plain"),
                          ("fp32", ref, "plain")):
        x = pe.float() if name == "fp32" else pe
        prefill = lambda: gen.prefill(p._decoder_params, p.config.decoder, x, pm,
                                       cache_len=bucket + 1, impl=impl)
        with recorded_routes(routes.setdefault(name, []), drops.setdefault(name, []),
                             first_input=STASH if name == "kernel" else None):
            if name == "kernel" and profile:
                state, prefill_profile = device_profile(torch, f"{mode} prefill", prefill)
            else:
                state = prefill()
        logits[name] = compute_logits(p._decoder_params, state[2], impl=impl)
        if name == "kernel" and profile:
            step_profile = profile_decode_step(torch, pipe, cfg.decoder, state, mode)
        del state
    del ref
    if not torch.isfinite(logits["kernel"]).all():
        fail("non-finite logits")
    flips = {}
    if routes["fp32"]:
        real = pm.reshape(-1).cpu()
        for name in ("kernel", "plain"):
            flips[f"{name}_vs_fp32"] = [
                (a != b).any(dim=-1)[real].float().mean().item()
                for a, b in zip(routes[name], routes["fp32"])]
        print(f"{mode}: share of the prefill's {int(real.sum())} real tokens whose top-"
              f"{cfg.decoder.top_k} experts differ from the fp32 model's, layer by layer: "
              f"kernel path {[round(f, 5) for f in flips['kernel_vs_fp32']]}, plain path "
              f"{[round(f, 5) for f in flips['plain_vs_fp32']]}", flush=True)
    if drops["fp32"]:
        flips["dropped"] = drops
        print(f"{mode}: assignments the sparse dispatch drops, layer by layer, of "
              f"{pm.numel() * cfg.decoder.top_k} ({pm.numel() - int(pm.sum())} pad rows): "
              f"{drops}", flush=True)
    errs = {}
    for what, v in (("prefix", prefixes), ("logits", logits)):
        errs[what] = {"kernel_vs_plain": rel_err(v["kernel"], v["plain"]),
                      "kernel_vs_fp32": rel_err(v["kernel"], v["fp32"]),
                      "plain_vs_fp32": rel_err(v["plain"], v["fp32"])}

    plain.infer_events_batch(videos, stamps, asks, max_new_tokens=MAX_NEW)
    ptok = plain.last_stats["tokens"]
    agree = []
    for a, b in zip(tokens, ptok):
        n = 0
        while n < len(a) and a[n] == b[n]:
            n += 1
        agree.append(n)
    for what, e in errs.items():
        print(f"{mode} {what} (||diff|| / ||ref||): kernel vs plain "
              f"{e['kernel_vs_plain']:.5f}, kernel vs fp32 {e['kernel_vs_fp32']:.5f}, "
              f"plain vs fp32 {e['plain_vs_fp32']:.5f} (tol: kernel vs fp32 <= "
              f"{REF_RATIO_TOL} x plain vs fp32)", flush=True)
    print(f"{mode}: greedy tokens of the kernel path equal the plain path's for the "
          f"first {agree} of {MAX_NEW} per row", flush=True)
    for what, e in errs.items():
        if not e["kernel_vs_fp32"] <= REF_RATIO_TOL * e["plain_vs_fp32"]:
            fail(f"{mode} {what}: the kernel path is further from the fp32 reference "
                 "than the plain path")
    del plain
    torch.cuda.empty_cache()
    return {**errs, "greedy_agree": agree, "routing_flips": flips,
            "decode_step": step_profile, "encode_profile": encode_profile,
            "prefill_profile": prefill_profile}


def request_inputs():
    """Phase 4's requests (phase 11's too): VIDEOS synthetic FRAMES-frame
    336x336 videos from SEED, their timestamps and instructions."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    videos = [rng.integers(0, 256, (FRAMES, 336, 336, 3), dtype=np.uint8)
              for _ in range(VIDEOS)]
    stamps = [[[float(i)] for i in range(FRAMES)]] * VIDEOS
    asks = ["Localize the visual events in the video and describe each one.",
            "Find every moment where something changes, with timestamps."]
    return videos, stamps, asks


def serving_model(torch, mode: str, layers: int = 0):
    """(params, config) of phase 4's TRACE-7B from SEED in the bf16 or the
    int8 serving configuration (``layers`` > 0 cuts the decoder's depth)."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import int8_serving
    from trace_tpu_torch.params import init_trace_params

    cfg = TraceConfig()
    if layers:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                   num_layers=layers))
    params = init_trace_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    if mode == "int8":
        params, cfg = int8_serving(params, cfg)
    return params, cfg


def end_to_end(torch, mode: str):
    """Phase 4: the serving path at full width, two requests, in the bf16
    (``mode="bf16"``) or the int8 (``"int8"``) configuration at a depth of
    SERVE_LAYERS, or the int4p serving
    configuration with group-128 scales at a depth of INT4P_LAYERS
    (``"int4p"``); ``"int4p_g0"`` is the int4p configuration with
    per-channel scales at a depth of G0_LAYERS."""
    import numpy as np

    from trace_tpu_torch import EventPredictions
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import int4p_serving, int8_serving
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    int8 = mode == "int8"
    quantized = mode != "bf16"  # int8 KV cache, int8 lm_head, W8A8 ViT
    cfg = TraceConfig()
    layers = {"int4p": INT4P_LAYERS, "int4p_g0": G0_LAYERS}.get(mode, SERVE_LAYERS)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=layers))
    t0 = time.perf_counter()
    params = init_trace_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    # the dense tree is dropped here
    if int8:
        params, cfg = int8_serving(params, cfg)
    elif mode == "int4p":
        params, cfg = int4p_serving(params, cfg)
    elif mode == "int4p_g0":
        params, cfg = int4p_serving(params, cfg, group=0)
    torch.cuda.synchronize()
    print(f"init ({mode}): random TRACE-7B weights ({cfg.decoder.num_layers} decoder layers) "
          f"in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card", flush=True)
    tok = SpmLikeTokenizer()
    pipe = TracePipeline(params, cfg, tok)
    videos, stamps, asks = request_inputs()
    vit_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    chunks = VIDEOS * FRAMES // cfg.vit_chunk_size
    L = cfg.decoder.num_layers

    launches, stats = None, []
    for request in (1, 2):
        reset_serving_launches()
        t0 = time.perf_counter()
        preds = pipe.infer_events_batch(videos, stamps, asks, max_new_tokens=MAX_NEW)
        wall = time.perf_counter() - t0
        got = serving_launches()
        s = pipe.last_stats
        steps = s["decode_steps"]
        # what the code implies: one ViT attention per layer and chunk, one
        # flash attention per decoder layer (prefill), one decode attention
        # per layer and step; quantized: four weight products per layer and
        # step (wqkv, wo, w_gateup, w_down) through the tree's kernel (int8
        # stacked; packed int4 per channel or grouped, split-K form) and one
        # 2-D int8 product per lm_head call (the prefill's last position, then
        # every step), at 2 rows of x the form for up to 8. The prefill is
        # W8A8 / W4A8 (no kernel of these) except on group-scaled int4p
        # leaves: four tensor-core-form products a layer
        want = dict.fromkeys(got, 0)
        want.update({"vit_attention_btd": vit_layers * chunks, "flash_attention": L})
        if quantized:
            step_kernel = {"int8": "quant_matmul_stacked", "int4p": "quant_matmul_p4_grouped",
                           "int4p_g0": "quant_matmul_p4"}[mode]
            want.update({"decode_attention_int8_s8dot": L * steps,
                         step_kernel: 4 * L * steps, "quant_matmul": steps + 1})
            if mode == "int4p":
                want["quant_matmul_p4_grouped_mma"] = 4 * L
        else:
            want["decode_attention"] = L * steps
        print(f"{mode} request {request}: launches {got} expected {want}; "
              f"{s['prefix_tokens']} prefix tokens, {steps} decode steps; "
              f"wall {wall:.3f} s, encode {s['encode_s']:.3f} s "
              f"({VIDEOS * FRAMES / s['encode_s']:.1f} ViT frames/s), "
              f"prefill {s['prefill_s']:.3f} s, decode "
              f"{1e3 * s['decode_s'] / max(steps, 1):.2f} ms/step", flush=True)
        if got != want or steps <= 0:
            fail(f"launch counts {got} != expected {want}")
        if not all(isinstance(p, EventPredictions) for p in preds):
            fail("output does not parse into EventPredictions")
        check_head_slices(cfg.decoder, s["tokens"])
        launches = launches or got
        stats.append({k: v for k, v in s.items() if k != "tokens"}
                     | {"wall_s": wall, "mode": mode})
    tokens = pipe.last_stats["tokens"]
    if int8:
        launches.update(dequant_request(torch, params, cfg, tok, videos, stamps, asks))
    if mode == "int4p_g0":
        launches.update(weight_only_request(torch, params, cfg, tok, videos, stamps, asks))

    check = reference_check(torch, pipe, params, cfg, tok, videos, stamps, asks, mode, tokens)
    if mode == "bf16":
        check["chunked_prefill"] = chunked_prefill_check(torch, pipe, "bf16", CHUNK_TOL_BF16)
    del pipe, params
    torch.cuda.empty_cache()
    return launches, stats, check


# Chunked prefill (phase 4, and phase 7's fp32 pipeline): one request's
# prefix prefilled in two chunks through decoder_forward, the second at
# cache_index > 0 (row 1 with a query offset on the card), against the
# one-shot prefill: the last position's logits, ||diff|| / ||ref||. fp32: the
# same fp32 steps in another order, 1e-3. bf16 at 32 layers of random
# weights: the online softmax may round p at other points in the two runs,
# and random weights amplify a bf16 step over the layers; a chunk that saw
# the wrong slots moves the logits by their own size. 0.1. Over an int8 KV
# cache the second chunk attends the quantized stripe (as the JAX package's
# einsum path does) where the one-shot prefill attends its unquantized k / v,
# and activation and cache roundings that flip between two runs are
# amplified over the layers (the fp32 int8 tree at 4 layers: 0.076 on both
# routes, 0.035 between the routes' chunked logits; my chip call 3, PR 20):
# there the kernel route's chunked logits may lie at most REF_RATIO_TOL x as
# far from its one-shot prefill as the plain route's do.
CHUNK_TOL_F32 = 1e-3
CHUNK_TOL_BF16 = 0.1


def chunked_prefill_check(torch, pipe, label: str, tol: float, encoded=None) -> dict:
    """The first request's first video (or ``encoded``, a (prefix, mask) of
    one row the caller encoded): its prefix prefilled at once and in
    two chunks (cut at the middle) into a fresh cache, through the kernels
    and through the plain versions; each route's two last-position logits
    within ``tol`` (||diff|| / ||ref||). Over an int8 KV cache (see
    CHUNK_TOL_F32) the kernel route's distance at most REF_RATIO_TOL x the
    plain route's instead. Then the second chunk once more with a cache
    mask that also marks slots inside and past it (its second half and the
    8 unwritten slots after the prefix, which the one-launch route's causal
    offset would hide): on the card two launches of row 8 a layer merged
    by their logsumexp; its kernel route's logits within ``tol`` or
    REF_RATIO_TOL x the unmarked chunk's distance between the routes of the
    plain route's."""
    from trace_tpu_torch.kernels.flash_backward import flash_attention_fwd_res as fwd_res
    from trace_tpu_torch.model.mistral import compute_logits, decoder_forward, init_kv_cache

    if encoded is None:
        videos, stamps, asks = request_inputs()
        encoded = pipe.encode_prefix(videos[:1], stamps[:1], asks[:1])
    prefix, mask = encoded
    dec, c = pipe._decoder_params, pipe.config.decoder
    P = prefix.shape[1]
    S, cut = P + 8, P // 2
    pos = (mask.long().cumsum(-1) - 1).clamp_min(0)
    out = {"prefix_tokens": P, "cut": cut}
    quantized = c.kv_cache_dtype == "int8"
    chunked, marked = {}, {}
    for impl in ("auto", "plain"):
        with torch.no_grad():
            cache = init_kv_cache(c, 1, S, dtype=prefix.dtype, device="cuda")
            h, _ = decoder_forward(dec, c, prefix, mask, pos, cache=cache, cache_index=0,
                                   impl=impl)
            one = compute_logits(dec, h[:, -1], impl=impl)
            cache = init_kv_cache(c, 1, S, dtype=prefix.dtype, device="cuda")
            _, cache = decoder_forward(dec, c, prefix[:, :cut], mask[:, :cut], pos[:, :cut],
                                       cache=cache, cache_index=0, impl=impl)
            cmask = torch.zeros((1, S), dtype=torch.bool, device="cuda")
            cmask[:, :cut] = mask[:, :cut]
            h, _ = decoder_forward(dec, c, prefix[:, cut:], mask[:, cut:], pos[:, cut:],
                                   cache=cache, cache_index=cut, cache_mask=cmask, impl=impl)
            two = compute_logits(dec, h[:, -1], impl=impl)
            cmask[:, cut + (P - cut) // 2:] = True
            before = fwd_res.launches + fwd_res.launches_f32
            h, _ = decoder_forward(dec, c, prefix[:, cut:], mask[:, cut:], pos[:, cut:],
                                   cache=cache, cache_index=cut, cache_mask=cmask, impl=impl)
            marked[impl] = compute_logits(dec, h[:, -1], impl=impl)
            launched = fwd_res.launches + fwd_res.launches_f32 - before
        del cache, h
        if launched != (2 * c.num_layers if impl == "auto" else 0):
            fail(f"chunked prefill ({label}, {impl}): the marked chunk launched row 8 "
                 f"{launched} times, expected two a layer on the kernel route")
        chunked[impl] = two
        e = rel_err(two, one)
        same = bool((two.argmax(-1) == one.argmax(-1)).all())
        out[impl] = {"rel_err": e, "argmax_equal": same}
        print(f"chunked prefill ({label}, {c.num_layers} layers, {impl} route): {P} prefix "
              f"tokens in chunks of {cut} and {P - cut}; last-position logits from the one-shot "
              f"prefill's {e:.3g} (||diff|| / ||ref||{'' if quantized else f', tol {tol}'}), "
              f"argmax equal {same}", flush=True)
        if not torch.isfinite(two).all() or (not quantized and e > tol):
            fail(f"chunked prefill ({label}, {impl}): the logits differ from the one-shot "
                 "prefill's")
    if quantized:
        out["kernel_vs_plain"] = rel_err(chunked["auto"], chunked["plain"])
        print(f"chunked prefill ({label}, int8 KV cache): the kernel route's chunked logits "
              f"from the plain route's {out['kernel_vs_plain']:.3g}; limit: the kernel route's "
              f"distance from its one-shot prefill <= {REF_RATIO_TOL} x the plain route's",
              flush=True)
        if out["auto"]["rel_err"] > REF_RATIO_TOL * out["plain"]["rel_err"]:
            fail(f"chunked prefill ({label}): the kernel route's chunked prefill is further "
                 "from its one-shot prefill than the plain route's")
    routes = rel_err(chunked["auto"], chunked["plain"])
    limit = max(tol, REF_RATIO_TOL * routes)
    out["marked"] = {"kernel_vs_plain": rel_err(marked["auto"], marked["plain"]),
                     "unmarked_kernel_vs_plain": routes, "limit": limit,
                     "moved_by_the_marks": rel_err(marked["plain"], chunked["plain"])}
    m = out["marked"]
    print(f"chunked prefill ({label}): a chunk whose cache mask marks {S - cut - (P - cut) // 2} "
          f"slots inside and past it, kernel route (two row-8 launches a layer) from the plain "
          f"route {m['kernel_vs_plain']:.3g} (limit {limit:.3g}: {tol} or {REF_RATIO_TOL} x "
          f"the unmarked chunk's {routes:.3g}); the marks move the plain route's logits by "
          f"{m['moved_by_the_marks']:.3g}", flush=True)
    if not torch.isfinite(marked["auto"]).all() or m["kernel_vs_plain"] > limit:
        fail(f"chunked prefill ({label}): a chunk with marked slots past its index differs "
             "between the kernel and the plain route")
    return out


# Phase 4's fp32 trees: TraceConfig(dtype=float32) at F32_LAYERS layers in the
# int8 (model_init's: int8 decoder, int8 KV cache, W8A8 prefill, fp32 ViT),
# int4 (native, per channel, weight-only) and int4p (group 128, weight-only)
# serving configurations; one request each of F32_NEW tokens. 2 layers: cut
# from 4 when my chip call 4 (PR 20) ran the whole smoke in 1033 s
F32_LAYERS = 2
F32_NEW = 16
F32_ROWS = {  # the rows each fp32 tree's request launches, and no other
    "int8": {"flash_attention_f32", "vit_attention_btd_f32", "decode_attention_int8_s8dot_f32",
             "quant_matmul_f32", "quant_matmul_stacked_f32"},
    "int4": {"flash_attention_f32", "vit_attention_btd_f32", "decode_attention_int8_s8dot_f32",
             "quant_matmul_f32", "quant_matmul_p4_f32", "quant_matmul_p4_f32_tiled"},
    "int4p": {"flash_attention_f32", "vit_attention_btd_f32", "decode_attention_int8_s8dot_f32",
              "quant_matmul_f32", "quant_matmul_p4_grouped_f32",
              "quant_matmul_p4_grouped_f32_tiled"},
}


def fp32_trees(torch) -> tuple:
    """Phase 4's fp32 trees (see F32_ROWS): per tree one request of phase 4's
    videos with check (e) on the path's own inputs, the rows launched exactly
    those of F32_ROWS, no plain version on the card; the int8 tree once more
    with decode_attn_int8="dequant" (8 tokens) and the chunked prefill
    check. Returns (each row's launches on the first tree that runs it,
    stats)."""
    import gc

    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import int4_serving, int4p_serving, int8_serving
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    videos, stamps, asks = request_inputs()
    tok = SpmLikeTokenizer()
    serving = {"int8": lambda p, c: int8_serving(p, c, vision=False), "int4": int4_serving,
               "int4p": lambda p, c: int4p_serving(p, c, vision=False)}
    launches, stats = {}, {}
    for mode, serve in serving.items():
        t0 = time.perf_counter()
        cfg = TraceConfig(dtype=torch.float32)
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                   num_layers=F32_LAYERS))
        params, cfg = serve(init_trace_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED)), cfg)
        pipe = TracePipeline(params, cfg, tok)
        del params
        pipe._prepare_memory_layout()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        runs = [("request", cfg, F32_NEW)]
        if mode == "int8":
            runs.append(("dequant", dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, decode_attn_int8="dequant")), 8))
        st = stats[mode] = {"init_s": init_s}
        for run, rcfg, new in runs:
            pipe.config = rcfg
            plain, undo = watch_plain(torch)
            reset_serving_launches()
            try:
                t0 = time.perf_counter()
                _, check_e = on_path(torch, f"fp32 {mode} {run}", lambda: pipe.infer_events_batch(
                    videos, stamps, asks, max_new_tokens=new))
                wall = time.perf_counter() - t0
            finally:
                undo()
            got = {k: v for k, v in serving_launches().items() if v}
            want = F32_ROWS[mode] if run == "request" else (
                F32_ROWS[mode] - {"decode_attention_int8_s8dot_f32"}
                | {"decode_attention_int8_dequant_f32"})
            ran_plain = {k: v for k, v in plain.items() if v}
            s = pipe.last_stats
            steps = s["decode_steps"]
            st[run] = {"wall_s": wall, "encode_s": s["encode_s"], "prefill_s": s["prefill_s"],
                       "decode_ms_per_step": 1e3 * s["decode_s"] / max(steps, 1),
                       "launches": got, "check_e": check_e}
            print(f"fp32 {mode} tree ({F32_LAYERS} layers), {run}: launches {got}; "
                  f"{s['prefix_tokens']} prefix tokens; wall {wall:.2f} s, encode "
                  f"{s['encode_s']:.3f} s, prefill {s['prefill_s']:.3f} s, decode "
                  f"{st[run]['decode_ms_per_step']:.2f} ms/step over {steps} steps; plain "
                  f"versions on the card {ran_plain or 'none'}", flush=True)
            if set(got) != want or ran_plain or steps <= 0:
                fail(f"fp32 {mode} {run}: rows launched {sorted(got)}, expected {sorted(want)}; "
                     f"plain versions on the card {ran_plain}")
            check_head_slices(cfg.decoder, s["tokens"])
            for name, n in got.items():
                launches.setdefault(name, n)
        pipe.config = cfg
        if mode == "int8":
            st["chunked_prefill"] = chunked_prefill_check(torch, pipe, "fp32 int8 tree",
                                                          CHUNK_TOL_F32)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return launches, stats


CORPUS_VIDEOS = 64      # two decode chunks of CORPUS_BATCH
# the corpus model's decoder depth: its decode loop is host-paced at a cost
# per layer, and 32 layers beside phase 11 put the whole smoke at 1087-1098 s
# of the 1200 on the card; 16 (PR 18) at 1048 s with PR 20's fp32 checks
# (my chip call 6, PR 20). At 8 its videos/s are not the 32-layer model's
CORPUS_LAYERS = 8
CORPUS_POOL = 4         # distinct videos, prepared before the passes, cycled
CORPUS_BATCH = 32       # the bench's decode batch
CORPUS_BUDGET = 512     # the arena's new-token budget, shared by both passes
CORPUS_PASSES = (("A", False, 256), ("B", True, 512))  # name, streamed, new tokens
CORPUS_HW = (360, 640)  # a 16:9 source, as the bench sends it
CORPUS_ASK = ("Localize a series of activity events in the video, output the start "
              "and end timestamp for each event, and describe each event with sentences.")
CORPUS_ROWS = ("flash_attention", "vit_attention_btd", "decode_attention_int8_s8dot",
               "quant_matmul_wide", "quant_matmul_stacked_wide")
# (b): the card's patches against the CPU's, bf16, the limits of
# tests/test_torch_yuv.py: one bf16 step of the value (2^-7 |value|, plus the
# fp32 difference of 2e-6 for values near 0) at most, in at most
# PATCH_FLIP_SHARE of the elements
PATCH_F32_TOL = 2e-6
PATCH_FLIP_SHARE = 1e-3


def int8_product_launches(quant_matmul, quant_matmul_stacked) -> dict:
    """The int8 products' launches by form, under their rows' names: up to
    8 rows of x (``quant_matmul``, ``quant_matmul_stacked``) and the wide
    tile (``..._wide``)."""
    return {f"{fn.__name__}{'' if form == 'splitk' else '_' + form}": n
            for fn in (quant_matmul, quant_matmul_stacked)
            for form, n in fn.launches_by_form.items()}


# depth of on_path's reference calls in progress: watch_plain does not count
# the plain versions they run on purpose
HOLDING = {"depth": 0}


def watch_plain(torch):
    """Wrap every plain version of a kernel wrapper in its module so that a
    call with a CUDA tensor is counted, unless on_path makes it to hold a
    kernel; returns (counts, undo)."""
    from trace_tpu_torch.kernels import decode_attention as da
    from trace_tpu_torch.kernels import flash_attention as fa
    from trace_tpu_torch.kernels import quant_matmul as qm

    names = {fa: ("xla_attention", "vit_attention_btd_reference"),
             da: ("grouped_attention", "decode_attention_bf16",
                  "decode_attention_int8_s8dot", "decode_attention_int8_dequant"),
             qm: ("quant_matmul_plain", "quant_matmul_p4_plain",
                  "quant_matmul_p4_grouped_plain")}
    counts, saved = {}, []

    def watched(orig, name):
        def wrapped(*a, **k):
            if not HOLDING["depth"] and any(torch.is_tensor(x) and x.is_cuda for x in a):
                counts[name] += 1
            return orig(*a, **k)
        return wrapped

    for mod, fns in names.items():
        for name in fns:
            saved.append((mod, name, getattr(mod, name)))
            counts[name] = 0
            setattr(mod, name, watched(getattr(mod, name), name))
    # the int8 decode wrapper reaches its plain bodies through a table
    saved_table = dict(da._PLAIN_INT8)
    for mode, fn in saved_table.items():
        da._PLAIN_INT8[mode] = watched(fn, fn.__name__)

    def undo():
        for mod, name, orig in saved:
            setattr(mod, name, orig)
        da._PLAIN_INT8.update(saved_table)
    return counts, undo


def on_path(torch, label: str, run):
    """Check (e): ``run()`` with the entries of rows 1-7 watched where the
    model calls them (the attention wrappers; for the weight products
    ``quant_apply`` and ``quant_apply_stacked``, which hand an int8 leaf to
    ``quant_matmul`` and ``quant_matmul_stacked``, a nibble-packed one to
    ``quant_matmul_p4`` or, with group scales, ``quant_matmul_p4_grouped``). The
    first call of each at each input shape is repeated at once, before
    anything writes over its inputs, with ``impl="plain"``, and the two are
    held to the row's limits as phase 3 holds them: the weight products in
    units of max |ref|, the attention rows in their own units, on the query
    rows that see a key; each also ||diff|| / ||ref|| <= REL_NORM_TOL.
    Prints a line a call; returns {name at shape: the comparison}."""
    from trace_tpu_torch.kernels.quant_matmul import SPLIT_ROWS
    from trace_tpu_torch.model import mistral, vit

    def shape_of(x):
        """A tensor's shape, an int8 stripe's, else None (ints, flags: the
        layer index of a stacked weight too, so that layer 0 stands for all)."""
        if torch.is_tensor(x):
            return str(list(x.shape))
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k} {list(v.shape)}" for k, v in sorted(x.items())) + "}"
        return None

    def row_of(attr, a, k):
        """The row a call runs, or None for a call that reaches no kernel;
        fp32 operands run the fp32 form's row (``*_f32``)."""
        f32 = "_f32" * (a[0].dtype == torch.float32)
        if attr.startswith("quant_apply"):
            leaf = a[1]
            if not isinstance(leaf, dict):
                return None
            wide = a[0].numel() // a[0].shape[-1] > SPLIT_ROWS  # rows of x
            if "qp" in leaf:  # rows 6 and 7: the tensor-core (fp32: tiled) form beyond SPLIT_ROWS
                grouped = leaf["s"].shape[-2] > 1
                return ("quant_matmul_p4" + "_grouped" * grouped + f32
                        + ("_tiled" if f32 else "_mma") * wide)
            return "quant_matmul" + attr[len("quant_apply"):] + (f32 or "_wide" * wide)
        if attr == "decode_attention" and isinstance(a[1], dict):
            return f"decode_attention_int8_{k.get('mode', 's8dot')}{f32}"
        return attr + f32

    def held(name, a, out, ref):
        if name.startswith("quant_matmul"):
            unit = ref.abs().max()
            r = compare(name, out.float() / unit, ref.float() / unit)
            r["err"] *= unit.item()
            return r
        if name.startswith("vit_attention_btd"):
            tq = a[3]
            return compare(name, out[:, :tq], ref[:, :tq])
        if name.startswith("flash_attention"):  # every row: one that sees no key gets the mean of v
            return compare(name, out, ref)
        rows = (a[3] > -1e29).any(-1)  # [B, S]: the rows that see a key
        return compare(name, out[rows], ref[rows])

    results, saved = {}, []

    def watched(mod, attr):
        orig = getattr(mod, attr)

        def wrapped(*a, **k):
            out = orig(*a, **k)
            name = row_of(attr, a, k)
            shapes = ", ".join(filter(None, map(shape_of, a)))
            key = (name, shapes)
            if name and k.get("impl", "auto") == "auto" and key not in results:
                HOLDING["depth"] += 1
                try:
                    ref = orig(*a, **{**k, "impl": "plain"})
                finally:
                    HOLDING["depth"] -= 1
                results[key] = dict(held(name, a, out, ref), name=name, shapes=shapes)
            return out
        return wrapped

    for mod, attr in ((mistral, "flash_attention"), (vit, "vit_attention_btd"),
                      (mistral, "decode_attention"), (mistral, "quant_apply"),
                      (mistral, "quant_apply_stacked")):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, watched(mod, attr))
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    bad = []
    for r in results.values():
        atol, rtol = KERNEL_TOL[r["name"]]
        norm = NORM_TOL.get(r["name"], REL_NORM_TOL)
        print(f"corpus check (e), {label}: {r['name']} on [{r['shapes']}]: max_abs_err="
              f"{r['err']:.6g} excess={r['excess']:.3g} (|diff| <= {atol} + {rtol} |ref|) "
              f"rel_norm_err={r['rel_norm']:.3g} (<= {norm})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= norm):
            bad.append(f"{r['name']} on [{r['shapes']}]")
    if bad:
        fail(f"corpus (e), {label}: kernel and plain version disagree on the path's "
             f"inputs: {bad}")
    return out, {f"{r['name']} [{r['shapes']}]": {k: r[k] for k in ("err", "excess", "rel_norm")}
                 for r in results.values()}


def watch_backward(torch):
    """Check (e) for rows 9 and 10 in training: ``flash_attention_bwd`` (which
    ``_FlashAttentionTrainable.backward`` calls) wrapped so that its first
    call at each input shape is repeated at once, before anything writes over
    its inputs, through the plain versions of rows 9 and 10 (``impl="plain"``)
    on the kernel's own delta (the pre-pass again: the same bits), and the
    pair held to their phase-3 limits in units of max |ref| (rows ``*_f32``
    for fp32 operands). Returns (results {name at shape: the comparison},
    undo)."""
    from trace_tpu_torch.kernels import flash_backward as fb

    orig = fb.flash_attention_bwd
    results = {}

    def wrapped(q, k, v, mask_bias, o, lse, do, *, causal=False, impl="auto"):
        out = orig(q, k, v, mask_bias, o, lse, do, causal=causal, impl=impl)
        shapes = f"q {list(q.shape)}, k {list(k.shape)}"
        f32 = "_f32" * (q.dtype == torch.float32)
        if impl != "auto" or not q.is_cuda or ("flash_attention_bwd_dq" + f32, shapes) in results:
            return out
        HOLDING["depth"] += 1
        try:
            delta = fb.flash_attention_bwd_delta(o, do)
            refs = (fb.flash_attention_bwd_dq(q, k, v, mask_bias, do, lse, delta, causal=causal,
                                              impl="plain"),) + fb.flash_attention_bwd_dkv(
                q, k, v, mask_bias, do, lse, delta, causal=causal, impl="plain")
        finally:
            HOLDING["depth"] -= 1
        for name, got, ref in (("flash_attention_bwd_dq" + f32, out[:1], refs[:1]),
                               ("flash_attention_bwd_dkv" + f32, out[1:], refs[1:])):
            parts = []
            for a, b in zip(got, ref):
                unit = b.float().abs().max()
                r = compare(name, a.float() / unit, b.float() / unit)
                r["err"] *= unit.item()
                parts.append(r)
            results[(name, shapes)] = {k: max(r[k] for r in parts)
                                       for k in ("err", "excess", "rel_norm")}
        return out

    fb.flash_attention_bwd = wrapped

    def undo():
        fb.flash_attention_bwd = orig
    return results, undo


def corpus_phase(torch):
    """Phase 5: the bench's serving workload, cut to CORPUS_VIDEOS videos and
    CORPUS_LAYERS layers, through the port's entry points
    (``prepare_sample_host_np`` -> ``infer_events_corpus``) at full width,
    with checks (a)-(e) of the module docstring."""
    import numpy as np

    from trace_tpu_torch import EventPredictions
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.kernels.quant_matmul import quant_matmul, quant_matmul_stacked
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.mistral import compute_logits
    from trace_tpu_torch.model.quantize import int8_serving
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.video.preprocess import i420_band_to_patches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(TraceConfig(), upload_format="yuv420")
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               num_layers=CORPUS_LAYERS))
    params, cfg = int8_serving(
        init_trace_params(cfg, torch.Generator(device="cuda").manual_seed(SEED)), cfg)
    pipe = TracePipeline(params, cfg, SpmLikeTokenizer())
    del params
    torch.cuda.synchronize()
    gib = lambda n: n / 2 ** 30
    # where the peak is set: model set-up (bf16 weights quantized to int8),
    # then per pass the encode before the first chunk's prefill and the rest
    memory = {"setup_peak": gib(torch.cuda.max_memory_allocated()),
              "setup_held": gib(torch.cuda.memory_allocated())}
    rng = np.random.default_rng(SEED)
    ts = [[round(i * 1.7, 1)] for i in range(FRAMES)]
    t1 = time.perf_counter()
    pool = [pipe.prepare_sample_host_np(
        rng.integers(0, 256, (FRAMES,) + CORPUS_HW + (3,), dtype=np.uint8), ts, CORPUS_ASK)
        for _ in range(CORPUS_POOL)]
    prep_s = time.perf_counter() - t1
    spec = pool[0].frames_spec
    if spec[0] != "yuv_band_p":
        fail(f"corpus: a 640x360 video took route {spec[0]!r}, not the band patches")
    print(f"corpus: int8 TRACE-7B at {CORPUS_LAYERS} of 32 layers (yuv420) ready in {t1 - t0:.1f} s; {CORPUS_POOL} videos "
          f"{CORPUS_HW[1]}x{CORPUS_HW[0]} x {FRAMES} frames prepared on the host in "
          f"{prep_s:.2f} s ({spec[1].nbytes / 1e6:.2f} MB of I420 band each, "
          f"{len(pool[0].token_ids)} prompt tokens)", flush=True)

    # (b) the band's patches on the card against the same function on the CPU
    yuv, top, left, fill, size, patch = spec[1:]
    ref = i420_band_to_patches(torch.from_numpy(yuv), top, left, torch.from_numpy(fill),
                               size, patch, cfg.dtype).float()
    got = i420_band_to_patches(torch.from_numpy(yuv).cuda(), top, left,
                               torch.from_numpy(fill).cuda(), size, patch, cfg.dtype)
    diff = (got.float().cpu() - ref).abs()
    over = (diff - 2 ** -7 * ref.abs() - PATCH_F32_TOL).max().item()
    flips = (diff != 0).float().mean().item()
    patch_check = {"max_diff": diff.max().item(), "share_differing": flips}
    print(f"corpus check (b): card patches {tuple(got.shape)} vs CPU: max diff "
          f"{diff.max().item():.3g}, share differing {flips:.2e} (limits: one bf16 step "
          f"+ {PATCH_F32_TOL}, share <= {PATCH_FLIP_SHARE})", flush=True)
    if over > 0 or flips > PATCH_FLIP_SHARE:
        fail("corpus (b): i420_band_to_patches on the card disagrees with the CPU")
    del ref, got, diff

    # (e) row 2 on an encode batch's own inputs
    pipe._prepare_memory_layout()
    _, path = on_path(torch, "encode", lambda: pipe._encode_prepared(
        [pipe._upload_prepared(pool[i]) for i in range(2)])[0])

    fns = (flash_attention, vit_attention_btd, decode_attention, quant_matmul,
           quant_matmul_stacked)
    calls: dict = {}   # pass -> [(tokens, decode_steps)] per chunk, in order
    captured: dict = {}
    orig = gen.generate_split
    current = {"pass": None}

    def recording(*a, **k):
        window = memory[current["pass"]]
        if "encode_peak" not in window:  # the first chunk's prefill starts
            window["encode_peak"] = gib(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        if current["pass"] == "A" and "prefix" not in captured:
            pb = k["prefill_batch"]
            captured["prefix"] = a[2][0][:pb].clone()  # the list hands it over
            captured["mask"] = a[3][:pb].clone()
        out = orig(*a, **k)
        calls.setdefault(current["pass"], []).append((out.tokens, out.decode_steps))
        captured["arena"], captured["mask_last"] = out.cache, a[3]
        return out

    stats, plain_calls = {}, {}
    gen.generate_split = recording
    plain_counts, undo = watch_plain(torch)
    try:
        for name, streamed, new in CORPUS_PASSES:
            current["pass"] = name
            captured.pop("arena", None)  # the last pass's arena: not held into this one
            for fn in fns:
                fn.launches = 0
            for fn in (quant_matmul, quant_matmul_stacked):
                fn.launches_by_form.update(splitk=0, wide=0)
            for m in decode_attention.launches_int8:
                decode_attention.launches_int8[m] = 0
            plain_counts.update(dict.fromkeys(plain_counts, 0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            memory[name] = {"held_at_start": gib(torch.cuda.memory_allocated())}
            t0 = time.perf_counter()
            preds = pipe.infer_events_corpus(
                lambda i: pool[i % CORPUS_POOL], CORPUS_VIDEOS, encode_batch=2,
                decode_batch=CORPUS_BATCH, prefill_batch=2, max_new_tokens=new,
                token_budget=CORPUS_BUDGET, streamed=streamed)
            wall = time.perf_counter() - t0
            memory[name]["after_peak"] = gib(torch.cuda.max_memory_allocated())
            s = dict(pipe.last_corpus_stats)
            steps = sum(n for _, n in calls[name])
            got_launches = {"flash_attention": flash_attention.launches,
                            "vit_attention_btd": vit_attention_btd.launches,
                            "decode_attention_int8_s8dot": decode_attention.launches_int8["s8dot"],
                            **int8_product_launches(quant_matmul, quant_matmul_stacked)}
            s.update(wall_s=wall, videos_per_s=CORPUS_VIDEOS / wall, decode_steps=steps,
                     ms_per_step=1e3 * s["decode_loop_s"] / max(steps, 1),
                     launches=got_launches, new_tokens=new)
            stats[name] = s
            plain_calls[name] = {k: v for k, v in plain_counts.items() if v}
            print(f"corpus pass {name} ({'streamed' if streamed else 'two-phase'}, {new} new "
                  f"tokens, decode batch {CORPUS_BATCH}, prefill 2, encode 2): "
                  f"{CORPUS_VIDEOS} videos in {wall:.2f} s = {s['videos_per_s']:.4f} videos/s; "
                  f"encode_s {s['encode_s']}, prefill_s {s['prefill_s']}, decode_loop_s "
                  f"{s['decode_loop_s']}, decode_s {s['decode_s']}, prefix_tokens "
                  f"{s['prefix_tokens']}; {steps} decode steps at B = {CORPUS_BATCH}, "
                  f"{s['ms_per_step']:.2f} ms/step; launches {got_launches}; plain versions "
                  f"on the card: {plain_calls[name] or 'none'}", flush=True)
            if len(preds) != CORPUS_VIDEOS or not all(isinstance(p, EventPredictions)
                                                      for p in preds):
                fail(f"corpus pass {name}: outputs do not parse into EventPredictions")
            for toks, _ in calls[name]:
                check_head_slices(cfg.decoder, toks)
    finally:
        gen.generate_split = orig
        undo()

    serving_peak = max(memory["setup_peak"], *(v for name, *_ in CORPUS_PASSES
                                                for v in memory[name].values()))
    arena = captured["arena"]
    memory["arena"] = gib(sum(t.nbytes for t in arena.values()))
    bucket = arena["kq"].shape[3] - CORPUS_BUDGET  # a store: [32, bucket, D] bf16
    memory["store"] = gib(CORPUS_BATCH * bucket * cfg.decoder.hidden_size * 2)
    print(f"corpus memory (GiB allocated): set-up peak {memory['setup_peak']:.2f}, "
          f"{memory['setup_held']:.2f} held after (the int8 weights); "
          + "; ".join(f"pass {name}: {memory[name]['held_at_start']:.2f} held at its start, "
                      f"peak {memory[name]['encode_peak']:.2f} before the first chunk's "
                      f"prefill, {memory[name]['after_peak']:.2f} after"
                      for name, *_ in CORPUS_PASSES)
          + f"; the arena {memory['arena']:.2f}, a chunk's store {memory['store']:.2f}",
          flush=True)

    # (a) pass A's tokens are the first tokens of pass B's streams
    a_tok = np.concatenate([t for t, _ in calls["A"]])
    b_tok = np.concatenate([t for t, _ in calls["B"]])
    new_a = CORPUS_PASSES[0][2]
    same = a_tok[:, :new_a] == b_tok[:, :new_a]
    print(f"corpus check (a): {len(calls['A'])} + {len(calls['B'])} chunks; pass A's "
          f"{new_a} tokens equal pass B's first {new_a} in {int(same.all(1).sum())} of "
          f"{len(a_tok)} rows", flush=True)
    if a_tok.shape != b_tok.shape or not same.all() or (a_tok[:, new_a:] != gen.PAD_OUTPUT_ID).any():
        fail("corpus (a): two-phase pass A and streamed pass B disagree")

    # (d) every row of the path launched, no plain version on the card
    for name, s in stats.items():
        idle = [r for r in CORPUS_ROWS if s["launches"][r] <= 0]
        if idle or plain_calls[name]:
            fail(f"corpus (d): pass {name}: rows {idle} not launched, plain versions "
                 f"{plain_calls[name]} on the card")

    # one B = 32 decode step from the arena as pass B left it: the prefix
    # bucket and 511 generated slots visible, the last slot free
    arena, mask_last = captured.pop("arena"), captured.pop("mask_last")
    dec = pipe._decoder_params
    S = arena["kq"].shape[3]
    cache_mask = torch.zeros((CORPUS_BATCH, S), dtype=torch.bool, device="cuda")
    cache_mask[:, :mask_last.shape[1]] = mask_last
    cache_mask[:, mask_last.shape[1]:S - 1] = True
    g = torch.Generator(device="cuda").manual_seed(SEED)
    last = (torch.randn((CORPUS_BATCH, cfg.decoder.hidden_size), generator=g, device="cuda")
            .to(cfg.dtype))
    next_pos = cache_mask.sum(dim=1).int()
    step = decode_step_fn(torch, pipe, cfg.decoder, (arena, cache_mask, last, next_pos))
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # rows 4-5: the split kernel's instances are the int8 step's only ones
    _, step_profile = device_profile(torch, f"corpus decode step (B={CORPUS_BATCH}, S={S})",
                                     step, watch=("split_kernel",))
    # (e) rows 3b, 4 and 5 on the step's own inputs
    path.update(on_path(torch, "decode step", step)[1])
    step_profile["wall_ms"] = 1e3 * statistics.median(walls[1:])
    print(f"corpus decode step (B={CORPUS_BATCH}): {step_profile['wall_ms']:.2f} ms wall "
          "(median of 5, synchronised)", flush=True)
    del arena, cache_mask, step

    # (c) the first prefill sub-batch of pass A: first-token logits of the
    # kernel path, the plain path and an fp32 model of the dequantized weights
    prefix, mask = captured.pop("prefix"), captured.pop("mask")
    fcfg = dataclasses.replace(cfg.decoder, kv_cache_dtype="bf16", act_quant=False)
    logits = {}
    for what, p, c, impl in (("kernel", dec, cfg.decoder, "auto"),
                             ("plain", dec, cfg.decoder, "plain"),
                             ("fp32", None, fcfg, "plain")):
        if p is None:
            p = dequantized_fp32(dec)
        x = prefix.float() if what == "fp32" else prefix
        run = lambda: compute_logits(p, gen.prefill(
            p, c, x, mask, cache_len=prefix.shape[1] + 1, impl=impl)[2], impl=impl)
        if what == "kernel":  # (e) rows 1 and 4 on the prefill's own inputs
            logits[what], held = on_path(torch, "prefill", run)
            path.update(held)
        else:
            logits[what] = run()
        del p
    heads = gen.head_mask_table(cfg.decoder, "cuda")[1]
    first = (logits["kernel"] + heads).argmax(-1).cpu().numpy()
    if not np.array_equal(first, a_tok[:len(first), 0]):
        fail(f"corpus (c): recomputed first tokens {first} are not pass A's "
             f"{a_tok[:len(first), 0]}")
    errs = {"kernel_vs_plain": rel_err(logits["kernel"], logits["plain"]),
            "kernel_vs_fp32": rel_err(logits["kernel"], logits["fp32"]),
            "plain_vs_fp32": rel_err(logits["plain"], logits["fp32"])}
    print(f"corpus check (c): first-token logits of pass A's first prefill sub-batch "
          f"({tuple(prefix.shape)}): kernel vs plain {errs['kernel_vs_plain']:.5f}, kernel "
          f"vs fp32 {errs['kernel_vs_fp32']:.5f}, plain vs fp32 {errs['plain_vs_fp32']:.5f} "
          f"(tol: kernel vs fp32 <= {REF_RATIO_TOL} x plain vs fp32)", flush=True)
    if not errs["kernel_vs_fp32"] <= REF_RATIO_TOL * errs["plain_vs_fp32"]:
        fail("corpus (c): the kernel path is further from the fp32 reference than the plain path")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"corpus: peak {serving_peak:.2f} GiB allocated on the card through both passes, "
          f"{peak:.2f} GiB with check (c)'s fp32 decoder", flush=True)
    del pipe, logits, prefix
    torch.cuda.empty_cache()
    launches = {r: stats["A"]["launches"][r] for r in CORPUS_ROWS}
    return launches, {"passes": stats, "prep_s": prep_s, "peak_gib": serving_peak,
                      "peak_gib_with_check": peak, "memory_gib": memory,
                      "logits": errs, "on_path": path,
                      "decode_step": step_profile, "patch_check": patch_check}


TRAIN_STEPS = 4
# depth of the pretrain and lora runs: every layer runs the same shapes, and
# 32 layers put the whole smoke near 950 s of the 1200 with phase 11 to come;
# 8 (PR 18) at 1048 s with PR 20's fp32 checks
TRAIN_LAYERS = 4
SFT_LAYERS = 4   # depth of the sft run and of the gradient check
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
EVENT_LISTS = (
    [{"timestamp": [3.0, 21.0], "score": [4.5], "caption": "a person walks into the room"},
     {"timestamp": [21.0, 64.0], "score": [3.0], "caption": "they sit down and open a laptop"},
     {"timestamp": [70.0, 118.0], "score": [2.5], "caption": "the person types and then leaves"}],
    [{"timestamp": [0.0, 40.0], "score": [3.5], "caption": "a dog runs across a field"},
     {"timestamp": [55.0, 101.0], "score": [4.0], "caption": "it catches a ball and returns"}],
)


class SyntheticVideos:
    """VIDEOS synthetic FRAMES-frame 336x336 videos, one event list each,
    served round robin as ready training samples (the layout of
    ``EventDataset._build``). ``max_len`` is the smallest multiple of 128
    that drops no supervised label."""

    def __init__(self, cfg, tok, length: int):
        import numpy as np

        from trace_tpu_torch.data.dataset import (
            assemble_sequence,
            build_prompt_segments,
            event_response_segments,
        )
        from trace_tpu_torch.model.trace_model import tokens_per_frame
        from trace_tpu_torch.tokenizers.event_codec import TIME_CODEC

        rng = np.random.default_rng(SEED)
        n_video = FRAMES * tokens_per_frame(cfg)
        V = cfg.decoder.vocab_size
        parts = []
        for events in EVENT_LISTS[:VIDEOS]:
            segs, pos = build_prompt_segments(
                "Localize the visual events in the video and describe each one.",
                tok, n_video, text_vocab_size=V)
            segs = segs + event_response_segments(events, tok, text_vocab_size=V)
            parts.append((segs, pos))
        longest = max(sum(len(sg.ids) for sg in segs) + 1 for segs, _ in parts)  # + eos
        self.max_len = -(-longest // 128) * 128
        self.samples = []
        for segs, pos in parts:
            seq = assemble_sequence(segs, self.max_len, pos, text_vocab_size=V,
                                    eos_id=tok.eos_token_id)
            self.samples.append({
                "frames_u8": rng.integers(0, 256, (FRAMES, 336, 336, 3), dtype=np.uint8),
                "frame_time_ids": np.stack([TIME_CODEC.encode_value(float(i))
                                            for i in range(FRAMES)]).astype(np.int32),
                "token_ids": seq.token_ids, "labels": seq.labels,
                "time_labels": seq.time_labels, "score_labels": seq.score_labels,
                "attn_mask": seq.attn_mask, "video_pos": np.int32(seq.video_pos),
                "has_video": np.bool_(True),
            })
        self.length = length
        self.supervised = [int(sum((s[k] != -100).sum() for k in
                                   ("labels", "time_labels", "score_labels")))
                           for s in self.samples]
        self.real = [int(s["attn_mask"].sum()) for s in self.samples]

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return self.samples[i % len(self.samples)]

    def resized(self, length: int):
        """The same samples behind another length (steps x batch)."""
        other = copy.copy(self)
        other.length = length
        return other


def train_counts():
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd

    return {"vit_attention_btd": vit_attention_btd, "flash_attention": flash_attention,
            "flash_attention_fwd_res": fb.flash_attention_fwd_res,
            "flash_attention_bwd_dq": fb.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fb.flash_attention_bwd_dkv}


def train_params(torch, stage: str, layers: int, dtype=None, base=None):
    """(params, config) of a stage from SEED: TRACE-7B (or the TraceConfig
    ``base``) at ``layers`` decoder layers (in ``dtype``, default bf16);
    stage ``lora`` adds rank-128 fp32 adapters on the seven decoder
    projections, as the training CLI does."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.lora import add_lora_params
    from trace_tpu_torch.params import init_trace_params

    cfg = base or TraceConfig()
    cfg = cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=layers))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_trace_params(cfg, gen)
    if stage == "lora":
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, lora_r=128, lora_alpha=256.0))
        params["decoder"] = add_lora_params(params["decoder"], cfg.decoder, gen,
                                            targets=LORA_TARGETS)
        # B = 0 would hold every A gradient at zero for the first steps: small
        # random B, so that both adapter leaves take gradients and move
        for name, leaf in params["decoder"]["layers"].items():
            if name.endswith("_lora_b"):
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda") * 1e-3)
    return params, cfg


def train_stage(torch, stage: str, layers: int, data: "SyntheticVideos", tmp: Path):
    """One stage through ``train_loop``: a 1-step run, a 2-step run and the
    timed TRAIN_STEPS-step run, each from a fresh optimizer on the same
    parameters, with the checks of phase 6."""
    from trace_tpu_torch.train.train import TrainRecipe, make_train_step, param_group, \
        build_optimizer, train_loop, tree_paths

    t0 = time.perf_counter()
    params, cfg = train_params(torch, stage, layers)
    torch.cuda.synchronize()
    print(f"train {stage}: random TRACE-7B weights ({layers} decoder layers) in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB "
          f"on the card; {VIDEOS} videos x {FRAMES} frames, max_len {data.max_len} "
          f"(real tokens {data.real}, supervised labels {data.supervised})", flush=True)
    lr = {"pretrain": 1e-3, "lora": 1e-4, "sft": 5e-6}[stage]
    recipe = TrainRecipe(stage=stage, learning_rate=lr, total_steps=TRAIN_STEPS)
    leaves = dict(tree_paths(params))
    group = {p: param_group(p, stage) for p in leaves}
    frozen = [p for p in leaves if group[p] == "frozen"]
    trainable = [p for p in leaves if group[p] != "frozen"]
    before = {p: leaves[p].detach().clone() for p in trainable}

    def run(steps, **kw):
        return train_loop(params, cfg, data.resized(steps * VIDEOS), recipe,
                          batch_size=VIDEOS, log_every=0, **kw)

    def moved():
        return [p for p in trainable if not torch.equal(leaves[p].detach(), before[p])]

    # 1 step: the schedule starts at 0, no trainable leaf may move
    out, _, _ = run(1)
    if any(out_leaf is not leaves[p] for p, out_leaf in tree_paths(out)):
        fail(f"train {stage}: train_loop did not update the caller's tensors in place")
    if moved():
        fail(f"train {stage}: leaves moved in step 1, at learning rate 0: {moved()}")
    # 2 steps: every trainable leaf group has moved
    run(2)
    still = sorted(set(trainable) - set(moved()))
    print(f"train {stage}: after a 2-step run {len(moved())} of {len(trainable)} trainable "
          f"leaves moved; not moved: {still} (a bf16 norm scale of 1.0 cannot move by less "
          "than 2^-9)", flush=True)
    groups = lambda ps: {(p.split("/")[0], group[p]) for p in ps}
    if groups(moved()) != groups(trainable) or not moved():
        fail(f"train {stage}: a trainable group did not move by step 2")
    if stage == "sft" and not all(
            p in moved() for p in trainable if p.startswith("decoder/layers/w")):
        fail("train sft: a backbone weight did not move")
    if stage == "lora" and not all(p in moved() for p in trainable if "_lora_" in p):
        fail("train lora: an adapter leaf did not move")

    # the timed run
    counters = train_counts()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = tmp / f"train_{stage}.jsonl"
    log.unlink(missing_ok=True)
    t0 = time.perf_counter()
    train_loop(params, cfg, data.resized(TRAIN_STEPS * VIDEOS), recipe, batch_size=VIDEOS,
               log_every=1, metrics_path=str(log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {name: fn.launches for name, fn in counters.items()}
    records = [json.loads(line) for line in log.read_text().splitlines()]
    losses = [r["loss"] for r in records]
    if len(records) != TRAIN_STEPS or not all(
            all(x == x and abs(x) != float("inf") for x in
                (r["loss"], r["text_loss"], r["time_loss"], r["score_loss"], r["grad_norm"]))
            for r in records):
        fail(f"train {stage}: a loss is not finite: {records}")
    vit_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    chunks = VIDEOS * FRAMES // cfg.vit_chunk_size
    # per step, with remat: the frozen ViT's attention once per layer and
    # chunk; per decoder layer the forward-with-lse kernel twice (forward and
    # the backward's recomputation) and each backward kernel once
    per_step = {"vit_attention_btd": vit_layers * chunks, "flash_attention": 0,
                "flash_attention_fwd_res": 2 * layers, "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers}
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    # the logger rounds wall_s to 0.01 s: the steps after the first
    step_s = (records[-1]["wall_s"] - records[0]["wall_s"]) / (TRAIN_STEPS - 1)
    print(f"train {stage}: {TRAIN_STEPS} steps in {wall:.2f} s, {step_s:.3f} s/step after the "
          f"first ({VIDEOS * data.max_len / step_s:.0f} tokens/s), peak "
          f"{peak:.2f} GiB allocated; losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(r['grad_norm'], 3) for r in records]}; launches per step {per_step}, "
          f"over the run {got} expected {want}", flush=True)
    if got != want:
        fail(f"train {stage}: launch counts {got} != expected {want}")
    for p, x in leaves.items():
        if not torch.isfinite(x).all():
            fail(f"train {stage}: non-finite values in {p}")
    # frozen leaves bit-equal to what the seed gave before any step: the tree
    # made anew (a copy kept through the run would double the peak above)
    del before
    fresh = dict(tree_paths(train_params(torch, stage, layers)[0]))
    for p in frozen:
        if not torch.equal(leaves[p].detach(), fresh[p]):
            fail(f"train {stage}: frozen leaf {p} changed")
    if not any(not torch.equal(leaves[p].detach(), fresh[p]) for p in trainable):
        fail(f"train {stage}: no trainable leaf differs from its initial value")
    del fresh
    stats = {"stage": stage, "layers": layers, "steps": TRAIN_STEPS, "wall_s": wall,
             "step_s": step_s, "peak_gib": peak, "losses": losses, "max_len": data.max_len,
             "launches_per_step": per_step}
    profile = None
    if stage == "pretrain":
        tx = build_optimizer(params, recipe)
        state = tx.init(params)
        step = make_train_step(cfg, tx, freeze_stage=stage)
        batch = one_batch(data)
        _, profile = device_profile(torch, "pretrain step (forward, backward, update)",
                                    lambda: step(params, state, batch), top=14,
                                    watch=("attn_fwd_kernel<128>", "attn_bwd_dq_kernel",
                                           "attn_bwd_dkv_kernel"))
        if isinstance(profile.get("device_busy_ms"), float):
            # against the untraced step: the profiler slows the host by a
            # varying amount, which the traced wall time includes
            share = profile["device_busy_ms"] / (1e3 * step_s)
            print(f"pretrain step: the card is busy {profile['device_busy_ms']:.0f} ms of a "
                  f"{1e3 * step_s:.0f} ms untraced step ({100 * share:.1f} %)", flush=True)
            profile["busy_share_of_untraced_step"] = share
        stats["profile"] = profile
    return params, cfg, got, stats


F32_TRAIN_STEPS = 2


def fp32_lora_steps(torch, data, tmp: Path) -> tuple:
    """Two ``lora`` steps of ``train_loop`` on TRACE-7B in fp32 at
    SFT_LAYERS layers (TraceConfig(dtype=float32), the rank-128 adapters of
    phase 6): the training attention through the fp32 forms of rows 2, 8, 9
    and 10 (K1 and K4), as many launches as the bf16 stage's, no bf16 form
    and no plain version on the card, finite losses, the adapters moved;
    check (e) of rows 9 and 10 on the step's own inputs (``watch_backward``;
    its plain reference counts in the peak). Returns (launches over the
    run, stats)."""
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.train.train import TrainRecipe, train_loop, tree_paths

    params, cfg = train_params(torch, "lora", SFT_LAYERS, dtype=torch.float32)
    layers = cfg.decoder.num_layers
    adapters = {p: x.detach().clone() for p, x in tree_paths(params) if "_lora_" in p}
    fns = {"vit_attention_btd_f32": vit_attention_btd, "flash_attention_f32": flash_attention,
           "flash_attention_fwd_res_f32": fb.flash_attention_fwd_res,
           "flash_attention_bwd_dq_f32": fb.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv_f32": fb.flash_attention_bwd_dkv}
    for fn in fns.values():
        fn.launches = fn.launches_f32 = 0
    recipe = TrainRecipe(stage="lora", learning_rate=1e-4, total_steps=F32_TRAIN_STEPS)
    log = tmp / "train_lora_f32.jsonl"
    log.unlink(missing_ok=True)
    plain, undo = watch_plain(torch)
    held, undo_held = watch_backward(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        train_loop(params, cfg, data.resized(F32_TRAIN_STEPS * VIDEOS), recipe,
                   batch_size=VIDEOS, log_every=1, metrics_path=str(log))
        torch.cuda.synchronize()
    finally:
        undo_held()
        undo()
    wall = time.perf_counter() - t0
    bad = []
    for (name, shapes), r in held.items():
        atol, rtol = KERNEL_TOL[name]
        norm = NORM_TOL.get(name, REL_NORM_TOL)
        print(f"train lora fp32 check (e): {name} on [{shapes}]: max_abs_err={r['err']:.6g} "
              f"excess={r['excess']:.3g} (|diff| <= {atol} + {rtol} |ref|, units of max |ref|) "
              f"rel_norm_err={r['rel_norm']:.3g} (<= {norm})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= norm):
            bad.append(f"{name} on [{shapes}]")
    if {name for name, _ in held} != {"flash_attention_bwd_dq_f32",
                                      "flash_attention_bwd_dkv_f32"} or bad:
        fail(f"train lora fp32 (e): rows 9 and 10 not held on the step's inputs, or kernel and "
             f"plain version disagree: {bad or sorted(held)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = [json.loads(line) for line in log.read_text().splitlines()]
    got = {name: fn.launches_f32 for name, fn in fns.items()}
    bf16 = {name: fn.launches for name, fn in fns.items() if fn.launches}
    vit_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    chunks = VIDEOS * FRAMES // cfg.vit_chunk_size
    want = {k: F32_TRAIN_STEPS * v for k, v in {
        "vit_attention_btd_f32": vit_layers * chunks, "flash_attention_f32": 0,
        "flash_attention_fwd_res_f32": 2 * layers, "flash_attention_bwd_dq_f32": layers,
        "flash_attention_bwd_dkv_f32": layers}.items()}
    moved = [p for p, x in tree_paths(params) if p in adapters and not torch.equal(
        x.detach(), adapters[p])]
    ran_plain = {k: v for k, v in plain.items() if v}
    losses = [r["loss"] for r in records]
    print(f"train lora fp32 ({layers} layers): {F32_TRAIN_STEPS} steps in {wall:.2f} s "
          f"({records[-1]['wall_s'] - records[0]['wall_s']:.2f} s the second), peak "
          f"{peak:.2f} GiB; losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(r['grad_norm'], 3) for r in records]}; fp32 launches {got} expected {want}; "
          f"bf16 launches {bf16 or 'none'}; plain versions on the card {ran_plain or 'none'}; "
          f"{len(moved)} of {len(adapters)} adapter leaves moved", flush=True)
    if (got != want or bf16 or ran_plain or len(records) != F32_TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses)):
        fail("train lora fp32: launch counts, plain versions or losses are not as expected")
    if not moved:
        fail("train lora fp32: no adapter leaf moved")
    del params, adapters
    torch.cuda.empty_cache()
    return {k: v for k, v in got.items() if v}, {
        "layers": layers, "steps": F32_TRAIN_STEPS, "wall_s": wall, "peak_gib": peak,
        "losses": losses, "grad_norms": [r["grad_norm"] for r in records],
        "second_step_s": records[-1]["wall_s"] - records[0]["wall_s"], "launches": got,
        "on_path": {f"{name} [{shapes}]": r for (name, shapes), r in held.items()}}


def one_batch(data):
    from trace_tpu_torch.data.dataset import collate_batch

    return collate_batch([data[i] for i in range(VIDEOS)])


def gradient_check(torch, params, cfg, data) -> dict:
    """Right, not only finite: one forward_train + backward of stage ``sft``
    at SFT_LAYERS layers through the kernels, against the same with every
    kernel replaced by its plain version and against an fp32 model of the
    same weights: the loss and the gradients of the connector, the towers
    and decoder layer 0. With random weights the model is ill-conditioned
    (see end_to_end), so the test is that the kernel path is no further from
    the fp32 model than the plain bf16 path is, within REF_RATIO_TOL; the
    scalar loss is also allowed two bf16 steps of its own size."""
    from trace_tpu_torch.model.trace_model import forward_train
    from trace_tpu_torch.train.train import _batch_to_device, param_group, \
        preprocess_batch_frames, tree_paths

    batch = _batch_to_device(one_batch(data), torch.device("cuda"))
    frames = preprocess_batch_frames(batch.pop("frames_u8"), dataclasses.replace(
        cfg, dtype=torch.float32))

    def run(tree, c, impl):
        for path, x in tree_paths(tree):
            x.requires_grad_(param_group(path, "sft") != "frozen")
            x.grad = None
        loss, _ = forward_train(tree, c, {**batch, "frames": frames.to(c.dtype)}, impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        grads = {}
        for path, x in tree_paths(tree):
            if x.grad is None:
                continue
            top = path.split("/")[0]
            if top in ("connector", "towers"):
                grads.setdefault(top, []).append(x.grad.float().flatten())
            elif path.startswith("decoder/layers/"):
                grads.setdefault("layer0", []).append(x.grad[0].float().flatten())
            x.grad = None
        return loss.item(), {k: torch.cat(v) for k, v in grads.items()}

    for fn in train_counts().values():
        fn.launches = 0
    kernel = run(params, cfg, "auto")
    if train_counts()["flash_attention_bwd_dkv"].launches != cfg.decoder.num_layers:
        fail("gradient check: the backward did not go through the kernels")
    plain = run(params, cfg, "plain")
    f32 = lambda t: t.detach().float()
    fp32_tree = {k: {kk: ({n: f32(t) for n, t in vv.items()} if isinstance(vv, dict)
                          else f32(vv)) for kk, vv in v.items()} for k, v in params.items()}
    ref = run(fp32_tree, dataclasses.replace(cfg, dtype=torch.float32), "plain")
    del fp32_tree
    out = {"loss": {"kernel": kernel[0], "plain": plain[0], "fp32": ref[0]}}
    print(f"sft gradient check ({cfg.decoder.num_layers} layers): loss kernel {kernel[0]:.5f}, "
          f"plain {plain[0]:.5f}, fp32 {ref[0]:.5f}", flush=True)
    if not abs(kernel[0] - ref[0]) <= max(REF_RATIO_TOL * abs(plain[0] - ref[0]),
                                          2 ** -7 * abs(ref[0])):
        fail("gradient check: the kernel path's loss is further from the fp32 model "
             "than the plain path's")
    if set(kernel[1]) != {"connector", "towers", "layer0"}:
        fail(f"gradient check: gradient groups {sorted(kernel[1])}")
    for name in kernel[1]:
        if not torch.isfinite(kernel[1][name]).all():
            fail(f"gradient check: non-finite gradient in {name}")
        e = {"kernel_vs_plain": rel_err(kernel[1][name], plain[1][name]),
             "kernel_vs_fp32": rel_err(kernel[1][name], ref[1][name]),
             "plain_vs_fp32": rel_err(plain[1][name], ref[1][name])}
        out[name] = e
        print(f"sft gradient check, {name} gradients (||diff|| / ||ref||): kernel vs plain "
              f"{e['kernel_vs_plain']:.5f}, kernel vs fp32 {e['kernel_vs_fp32']:.5f}, plain vs "
              f"fp32 {e['plain_vs_fp32']:.5f} (tol: kernel vs fp32 <= {REF_RATIO_TOL} x plain "
              f"vs fp32)", flush=True)
        if not e["kernel_vs_fp32"] <= REF_RATIO_TOL * e["plain_vs_fp32"]:
            fail(f"gradient check: the kernel path's {name} gradients are further from "
                 "the fp32 model than the plain path's")
    return out


def training(torch, tmp: Path):
    """Phase 6: stages pretrain and lora at TRAIN_LAYERS layers, sft at
    SFT_LAYERS layers, then the gradient check on the sft model."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    tok = SpmLikeTokenizer()
    data = SyntheticVideos(TraceConfig(), tok, VIDEOS)
    launches, stats = {}, []
    check = None
    for stage, layers in (("pretrain", TRAIN_LAYERS), ("lora", TRAIN_LAYERS),
                          ("sft", SFT_LAYERS)):
        params, cfg, got, st = train_stage(torch, stage, layers, data, tmp)
        for name, n in got.items():
            if n:
                launches.setdefault(name, n)  # over the stage's TRAIN_STEPS-step run
        stats.append(st)
        if stage == "sft":
            check = gradient_check(torch, params, cfg, data)
        del params
        torch.cuda.empty_cache()
    f32_launches, f32_stats = fp32_lora_steps(torch, data, tmp)
    launches.update(f32_launches)
    stats.append({"stage": "lora fp32", **f32_stats})
    return launches, stats, check


def device_profile(torch, label: str, fn, top: int = 8, watch: tuple = ()):
    """Run fn once under torch.profiler; print the device-busy time, the
    CUDA kernels that take most of it and those whose names hold a string of
    ``watch``. Returns (fn's result, summary)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    events = sum(n for _, n in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    if not by_name:
        print(f"{label}: traced wall {wall:.1f} ms; device time not measured", flush=True)
        return out, {"traced_wall_ms": wall, "device_busy_ms": "not measured"}
    print(f"{label}: traced wall {wall:.1f} ms, {events} device events, busy {busy:.1f} ms; "
          "most of it: " + "; ".join(f"{name[:60]} {ms:.1f} ms x{n}"
                                     for name, (ms, n) in ranked), flush=True)
    watched = {w: [sum(v[i] for name, v in by_name.items() if w in name) for i in (0, 1)]
               for w in watch}
    if watched:
        print(f"{label}, of which: " + "; ".join(f"{w} {ms:.1f} ms x{n}"
                                                for w, (ms, n) in watched.items()), flush=True)
    return out, {"traced_wall_ms": wall, "device_busy_ms": busy, "device_events": events,
                 "top": [[name[:80], ms, n] for name, (ms, n) in ranked], "watched": watched}


def decode_step_fn(torch, pipe, dec, state):
    """One decode step of the kernel path (decoder, combined logits, argmax)
    from a prefilled cache ``state`` whose last slot is free."""
    from trace_tpu_torch.model.mistral import compute_logits, decoder_forward

    params = pipe._decoder_params
    cache, cache_mask, last, next_pos = state
    ones = torch.ones((last.shape[0], 1), dtype=torch.bool, device="cuda")
    tok = compute_logits(params, last).argmax(-1)
    slot = cache_mask.shape[1] - 1  # the one free slot

    def step():
        h, _ = decoder_forward(params, dec, pipe._combined[tok][:, None].to(last.dtype),
                               ones, next_pos[:, None], cache=cache, cache_index=slot,
                               cache_mask=cache_mask)
        return compute_logits(params, h[:, -1]).argmax(-1)
    return step


def profile_decode_step(torch, pipe, dec, state, mode: str) -> dict:
    """One decode step of the kernel path (``decode_step_fn``): its wall time
    (median of 5, synchronised), and under torch.profiler the CUDA kernels it
    launches and the share of the step's wall time (profiled, so the host
    side is slowed) in which the device runs one."""
    from torch.profiler import ProfilerActivity, profile

    last = state[2]
    step = decode_step_fn(torch, pipe, dec, state)
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    out = {"wall_ms": 1e3 * statistics.median(walls[1:]),
           "device_events": len(on_device) or "not measured",
           "device_busy_ms": busy if on_device else "not measured",
           "traced_wall_ms": 1e3 * traced}
    print(f"{mode} decode step (B={last.shape[0]}): {out['wall_ms']:.2f} ms wall; traced: "
          f"{out['device_events']} device operations per step, busy {busy:.2f} ms of "
          f"{out['traced_wall_ms']:.2f} ms", flush=True)
    return out


# Phase 7: a TRACE checkpoint through the public API at full width. The
# checkpoint has the keys and shapes of the released TRACE-7B merged layout
# (the repo's manifest, 690 keys) in bf16, random values from seeded
# generators on the card, written here in ~5 GB safetensors shards.
CKPT_MANIFEST = "scripts/parity/manifest_trace7b_merged.json"
CKPT_SHARD_BYTES = 5 * 10 ** 9
CKPT_VIDEO_FRAMES = 256  # the .npy sources' frames, sampled to the config's 128
CKPT_VIDEOS = 4          # served with one file that does not load
CKPT_NEW = 64            # new tokens of a request
CKPT_ROWS = ("flash_attention", "vit_attention_btd", "decode_attention_int8_s8dot",
             "quant_matmul", "quant_matmul_stacked")
# the .mp4 files: the first CKPT_MP4 .npy sources written with cv2.VideoWriter
# (mp4v, 25 fps, 640x360, all 256 frames), each read back through
# video/io.py on the route this machine gives (container_reader)
CKPT_MP4 = 2
CKPT_MP4_FPS = 25.0
CKPT_BF16_ROWS = ("flash_attention", "vit_attention_btd", "decode_attention")
# the int4 request (model_init(quant="int4")): rows 1, 2, 3b, 4 (lm_head) and
# both forms of row 6 (split-K in the steps, tensor-core in the prefill)
CKPT_INT4_ROWS = ("flash_attention", "vit_attention_btd", "decode_attention_int8_s8dot",
                  "quant_matmul", "quant_matmul_p4", "quant_matmul_p4_mma")
# leaves held bit for bit against the bytes written: (key, its leaf, the
# converter's transform of the HF tensor)
CKPT_SAMPLES = (
    ("model.embed_tokens.weight", lambda p: p["decoder"]["embed"], lambda w: w),
    ("model.layers.17.self_attn.q_proj.weight", lambda p: p["decoder"]["layers"]["wq"][17],
     lambda w: w.t().reshape(4096, 32, 128)),
    ("model.layers.10.self_attn.o_proj.weight", lambda p: p["decoder"]["layers"]["wo"][10],
     lambda w: w.t().reshape(32, 128, 4096)),
    ("model.layers.31.mlp.down_proj.weight", lambda p: p["decoder"]["layers"]["w_down"][31],
     lambda w: w.t()),
    ("lm_head.weight", lambda p: p["decoder"]["lm_head"], lambda w: w.t()),
    ("model.vision_tower.vision_tower.vision_model.encoder.layers.23.mlp.fc1.weight",
     lambda p: p["vision"]["layers"]["fc1"][23], lambda w: w.t()),
    ("model.vision_tower.vision_tower.vision_model.embeddings.patch_embedding.weight",
     lambda p: p["vision"]["patch_embed"], lambda w: w.reshape(w.shape[0], -1).t()),
    ("model.mm_projector.readout.weight", lambda p: p["connector"]["readout"],
     lambda w: w.t()),
    ("model.time_tower.embed_tokens.weight", lambda p: p["towers"]["time"], lambda w: w),
)


def ckpt_value(torch, index: int, key: str, shape):
    """The bf16 tensor written for the ``index``-th key: norms 1, biases 0,
    connector slots N(0, 1), every other weight N(0, 0.02) (the scales of
    ``init_trace_params``), from a generator seeded with SEED + 1 + index;
    but a decoder's q / k / v projection biases (qwen2's) N(0, 0.1), so
    that the bias path moves the result."""
    qkv_bias = key.startswith("model.layers.") and key.endswith(
        ("q_proj.bias", "k_proj.bias", "v_proj.bias"))
    if key.endswith(("norm.weight", "layer_norm1.weight", "layer_norm2.weight",
                     "ln_vision.weight", ".bn.weight")):
        return torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    if key.endswith(".bias") and not qkv_bias:
        return torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1 + index)
    scale = 1.0 if key.endswith(".slots") else 0.1 if qkv_bias else 0.02
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


def write_safetensors(torch, path: Path, entries) -> None:
    """A safetensors file of bf16 tensors: an 8-byte little-endian header
    length, the JSON header (dtype, shape, data_offsets), then the raw
    little-endian bytes. ``entries``: (key, shape, make), ``make()`` giving
    the tensor, written one at a time."""
    header, offset = {}, 0
    for key, shape, _ in entries:
        n = 2 * math.prod(shape)
        header[key] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for key, shape, make in entries:
            t = make().cpu()
            if tuple(t.shape) != tuple(shape) or t.dtype != torch.bfloat16:
                fail(f"checkpoint writer: {key} is {tuple(t.shape)} {t.dtype}")
            f.write(t.view(torch.uint8).numpy())


def write_checkpoint(torch, path: Path, keys, cfg, model_type: str = "mistral") -> int:
    """The merged checkpoint dir: ``keys`` [(key, shape)] in manifest order
    over shards of about CKPT_SHARD_BYTES, and a config.json of ``cfg``'s
    geometry (scripts/parity/manifest.py ``_released_config``; a
    Mixtral-family decoder's experts and top-k too) under ``model_type``.
    Returns the bytes of tensor data."""
    path.mkdir(parents=True)
    shards, size = [[]], 0
    for index, (key, shape) in enumerate(keys):
        n = 2 * math.prod(shape)
        if size and size + n > CKPT_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append((key, shape, lambda i=index, k=key, sh=shape: ckpt_value(torch, i, k, sh)))
        size += n
    for i, entries in enumerate(shards):
        write_safetensors(torch, path / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors",
                          entries)
    d = cfg.decoder
    (path / "config.json").write_text(json.dumps({
        "architectures": ["TraceMistralForCausalLM"], "model_type": model_type,
        "vocab_size": d.vocab_size, "hidden_size": d.hidden_size,
        "intermediate_size": d.intermediate_size, "num_hidden_layers": d.num_layers,
        "num_attention_heads": d.num_heads, "num_key_value_heads": d.num_kv_heads,
        "head_dim": d.head_dim, "rope_theta": d.rope_theta, "rms_norm_eps": d.rms_eps,
        "time_vocab_size": d.time_vocab_size, "score_vocab_size": d.score_vocab_size,
        "mm_projector_type": cfg.mm_projector_type, "num_slots": cfg.num_slots,
        "num_frames": cfg.num_frames, "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_vision_tower": "openai/clip-vit-large-patch14-336", "torch_dtype": "bfloat16",
        **({"num_local_experts": d.num_experts, "num_experts_per_tok": d.top_k}
           if hasattr(d, "num_experts") else {})}))
    return sum(2 * math.prod(shape) for _, shape in keys)


class HostPeak:
    """The peak of this process's resident memory (VmRSS of
    /proc/self/status, which also counts the checkpoint's pages mapped and
    read), sampled every 20 ms while the ``with`` block runs; ``peak`` in
    GiB."""

    def __init__(self):
        import threading

        self.peak = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    self.peak = max(self.peak, int(line.split()[1]) / 2 ** 20)

    def _run(self):
        while not self._stop.wait(0.02):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self._sample()


def timed_calls(targets: dict):
    """Wrap each (object, attribute) of ``targets`` {label: (obj, attr)} so
    that its calls add their seconds to ``seconds[label]``; returns
    (seconds, undo)."""
    seconds, saved = dict.fromkeys(targets, 0.0), []
    for label, (obj, attr) in targets.items():
        orig = getattr(obj, attr)

        def wrapped(*a, _orig=orig, _label=label, **k):
            t0 = time.perf_counter()
            try:
                return _orig(*a, **k)
            finally:
                seconds[_label] += time.perf_counter() - t0
        saved.append((obj, attr, orig))
        setattr(obj, attr, wrapped)

    def undo():
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)
    return seconds, undo


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def write_mp4(path: Path, frames) -> None:
    """uint8 RGB ``frames`` [T, H, W, 3] written to ``path`` with
    cv2.VideoWriter (mp4v, CKPT_MP4_FPS), then opened again with cv2: the
    phase fails with OpenCV's own words where it cannot write or read mp4v."""
    import cv2
    import numpy as np

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), CKPT_MP4_FPS,
                             (frames.shape[2], frames.shape[1]))
    if not writer.isOpened():
        fail(f"cv2 {cv2.__version__} cannot write mp4v to {path}: VideoWriter did not open; "
             f"its video I/O: {cv2.getBuildInformation().split('Video I/O:')[-1][:400]}")
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))  # RGB to OpenCV's BGR
    writer.release()
    cap = cv2.VideoCapture(str(path))
    ok = cap.isOpened() and cap.read()[0]
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if not ok or count != len(frames):
        fail(f"cv2 {cv2.__version__} cannot read back {path.name} ({path.stat().st_size} "
             f"bytes): opened and read {ok}, {count} of {len(frames)} frames reported")


def video_request(torch, pipe, cfg, video: Path, label: str, rows, decoder=None) -> dict:
    """One ``infer_events`` on the file ``video``: EventPredictions, ``rows``
    launched, no plain version on the card, one container read on the route
    of ``container_reader`` for an ``.mp4`` (none for an ``.npy``), head
    slices; then
    ``infer_events_from_frames`` on ``load_video_frames(video)`` under check
    (e) (with ``decoder`` in place of the pipeline's decoder tree where
    given) gives the same tokens. Returns the request's stats."""
    import numpy as np

    from trace_tpu_torch import EventPredictions, infer_events
    from trace_tpu_torch.video.io import CONTAINER_READS, container_reader, load_video_frames

    route = container_reader().split()[0]
    reads = dict(CONTAINER_READS)
    reset_serving_launches()
    plain_counts, undo = watch_plain(torch)
    try:
        t0 = time.perf_counter()
        pred = infer_events(pipe, str(video), CORPUS_ASK, max_new_tokens=CKPT_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = serving_launches()
    tokens = pipe.last_stats["tokens"]
    plain = {k: v for k, v in plain_counts.items() if v}
    read = {k: CONTAINER_READS[k] - reads[k] for k in reads}
    s = pipe.last_stats
    print(f"checkpoint check {label}: infer_events on {video.name} ({route} route, reads "
          f"{read}): wall {wall:.2f} s (encode {s['encode_s']:.2f} s, prefill "
          f"{s['prefill_s']:.3f} s, {s['decode_steps']} steps "
          f"{1e3 * s['decode_s'] / max(s['decode_steps'], 1):.2f} ms/step), "
          f"{s['prefix_tokens']} prefix tokens; events {len(pred.timestamps)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; plain versions on the card: "
          f"{plain or 'none'}", flush=True)
    idle = [r for r in rows if launches[r] <= 0]
    want_read = {**dict.fromkeys(read, 0), **({route: 1} if video.suffix == ".mp4" else {})}
    if not isinstance(pred, EventPredictions) or idle or plain or read != want_read:
        fail(f"checkpoint {label}: output {type(pred).__name__}, rows {idle} not launched, "
             f"plain versions {plain} on the card, container reads {read} (want {want_read})")
    check_head_slices(cfg.decoder, tokens)
    frames, ts = load_video_frames(str(video), cfg.num_frames)
    own = pipe._decoder_params
    if decoder is not None:
        pipe._decoder_params = decoder
    try:
        _, held = on_path(torch, f"checkpoint request {label}", lambda: pipe.infer_events_from_frames(
            frames, ts, CORPUS_ASK, max_new_tokens=CKPT_NEW))
    finally:
        pipe._decoder_params = own
    if not np.array_equal(pipe.last_stats["tokens"], tokens):
        fail(f"checkpoint {label}: infer_events on {video.name} and infer_events_from_frames "
             f"on load_video_frames' output gave other tokens")
    print(f"checkpoint check {label}: infer_events_from_frames on load_video_frames' output "
          f"({frames.shape[1]}x{frames.shape[2]} frames)"
          f"{' with the reference decoder tree' if decoder is not None else ''} gave the same "
          f"{tokens.shape[1]} tokens", flush=True)
    return {"wall_s": wall, "encode_s": s["encode_s"], "prefill_s": s["prefill_s"],
            "decode_s": s["decode_s"], "decode_steps": s["decode_steps"],
            "prefix_tokens": s["prefix_tokens"], "launches": launches, "reads": read,
            "on_path": held}


def serve_check(pipe, paths, out: Path, label: str, bad: str) -> dict:
    """``serve`` over ``paths``: one JSONL line a file, exactly one an error,
    the one for ``bad``."""
    from trace_tpu_torch.runtime.serve_batch import serve

    result = serve(pipe, [str(p) for p in paths], str(out), frames=pipe.config.num_frames,
                   max_new_tokens=CKPT_NEW)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    errors = [line for line in lines if "error" in line]
    print(f"checkpoint check {label}: serve over {len(paths)} files: {len(lines)} JSONL lines, "
          f"{len(errors)} error ({errors[0]['error'][:60] if errors else ''}); "
          f"{result['videos_per_s']:.4f} videos/s ({result['seconds']:.2f} s, {CKPT_NEW} new "
          "tokens, decode batch 32)", flush=True)
    if len(lines) != len(paths) or len(errors) != 1 or bad not in errors[0]["video"]:
        fail(f"checkpoint {label}: serve did not write one line a video with the one error")
    return result


def checkpoint_phase(torch, tmp: Path) -> tuple:
    """Phase 7: write the TRACE-7B checkpoint, its .npy videos and two of
    them as .mp4 (cv2.VideoWriter, mp4v), then (a) ``model_init`` bf16:
    every key read once, every leaf's shape and dtype those of
    ``init_trace_params``, sampled leaves bit-equal to the bytes written, the
    tree on the card; (c') ``infer_events`` on an ``.mp4`` with (a)'s
    pipeline: EventPredictions, rows 1, 2 and 3 launched, no plain version on
    the card, one container read on the route ``container_reader`` names, the
    same tokens as ``infer_events_from_frames`` on ``load_video_frames``'
    output, whose kernels are held against their plain versions (check (e)
    of phase 5); (d') ``serve`` over the .mp4s and a junk .mp4: one JSONL
    line each, the junk one an error; (b) ``model_init`` int8: its decoder
    bit-equal to ``quantize_decoder_params`` + ``fuse_decoder_serving`` of
    (a)'s tree on the card, the set-up's peak card memory; (c) as (c') on an
    ``.npy`` with the int8 pipeline; (d) ``serve`` over the .npy videos and
    a file that does not load; (b') ``model_init(quant="int4")``: its
    decoder bit-equal to ``quantize_decoder_params(bits=4, pack=True,
    group=0)`` + ``fuse_decoder_serving`` of (a)'s tree on the card,
    weight-only with the int8 KV cache, the set-up's peak and the decoder's
    GiB; then (c') on an ``.mp4`` with rows 1, 2, 3b, 4 and both forms of
    row 6, whose check (e) runs (a)'s group-0 tree from the card."""
    import gc
    import shutil

    import cv2
    import numpy as np

    from trace_tpu_torch.checkpoint import convert
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import fuse_decoder_serving, quantize_decoder_params
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime import pipeline as pl
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.video.io import CONTAINER_READS, container_reader

    gib = lambda n: n / 2 ** 30
    t_phase = time.perf_counter()
    stats = {"container_reader": container_reader()}
    meminfo = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    stats["host"] = {"disk_free_gib": gib(shutil.disk_usage(tmp).free),
                     "ram_available_gib": int(meminfo["MemAvailable"].split()[0]) / 2 ** 20,
                     "ram_total_gib": int(meminfo["MemTotal"].split()[0]) / 2 ** 20}
    print(f"checkpoint: video containers read through {stats['container_reader']}; host: "
          f"{stats['host']['disk_free_gib']:.1f} GiB free on disk at {tmp}, "
          f"{stats['host']['ram_available_gib']:.1f} of {stats['host']['ram_total_gib']:.1f} "
          "GiB of RAM available", flush=True)

    manifest = json.loads((Path(__file__).resolve().parent / CKPT_MANIFEST).read_text())
    keys = [(k, tuple(v)) for k, v in manifest["keys"].items()]
    index = {k: i for i, (k, _) in enumerate(keys)}
    cfg = TraceConfig()
    ckpt = tmp / "trace-7b"
    t0 = time.perf_counter()
    nbytes = write_checkpoint(torch, ckpt, keys, cfg)
    stats["write_s"] = time.perf_counter() - t0
    files = sorted(ckpt.glob("*.safetensors"))
    print(f"checkpoint: {len(keys)} keys ({manifest['num_keys']} in the manifest, "
          f"{manifest['num_params']} parameters), {nbytes / 1e9:.2f} GB of bf16 in "
          f"{len(files)} shards written in {stats['write_s']:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    videos = []
    for v in range(CKPT_VIDEOS):
        videos.append(tmp / f"video{v}.npy")
        np.save(videos[-1], rng.integers(0, 256, (CKPT_VIDEO_FRAMES,) + CORPUS_HW + (3,),
                                         dtype=np.uint8))
    (tmp / "broken.npy").write_bytes(b"not a numpy file")
    t0 = time.perf_counter()
    stats["cv2"] = cv2.__version__
    mp4s = [tmp / (v.stem + ".mp4") for v in videos[:CKPT_MP4]]
    for v, m in zip(videos, mp4s):
        write_mp4(m, np.load(v))
    (tmp / "junk_container.mp4").write_bytes(b"not a video container")
    print(f"checkpoint: cv2 {stats['cv2']} wrote {', '.join(m.name for m in mp4s)} "
          f"({CKPT_VIDEO_FRAMES} frames {CORPUS_HW[1]}x{CORPUS_HW[0]}, mp4v, "
          f"{CKPT_MP4_FPS:g} fps; {sum(m.stat().st_size for m in mp4s) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s; containers read through "
          f"{stats['container_reader']}", flush=True)

    # (a) bf16
    reads, captured = {}, {}

    class Recording(dict):
        def __getitem__(self, k):
            reads[k] = reads.get(k, 0) + 1
            return super().__getitem__(k)

    orig_load, orig_convert = convert.load_checkpoint_tensors, convert.convert_trace_checkpoint

    def capturing(*a, **k):
        params, config = orig_convert(*a, **k)
        captured["leaves"] = {n: (tuple(t.shape), t.dtype)
                              for n, t in tree_leaves(params).items()}
        captured["samples"] = {key: leaf(params).clone() for key, leaf, _ in CKPT_SAMPLES}
        return params, config

    convert.load_checkpoint_tensors = lambda path: Recording(orig_load(path))
    convert.convert_trace_checkpoint = capturing
    tok = SpmLikeTokenizer()
    inits = {}
    try:
        for quant in ("bf16", "int8"):
            if quant == "int8":
                # (c') and (d') with (a)'s pipeline
                stats["request_mp4"] = video_request(torch, pipe, cfg, mp4s[0], "(c')",
                                                         CKPT_BF16_ROWS)
                stats["serve_mp4"] = serve_check(pipe, mp4s + [tmp / "junk_container.mp4"],
                                                 tmp / "serve_mp4.jsonl", "(d')",
                                                 "junk_container")
                # (a)'s decoder quantized on the card: (b)'s and (b')'s references
                t0 = time.perf_counter()
                ref = fuse_decoder_serving(quantize_decoder_params(pipe.params["decoder"]))
                ref = {"layers": {n: ref["layers"][n] for n in ("wqkv", "wo", "w_gateup", "w_down")},
                       "lm_head": ref["lm_head"]}
                torch.cuda.synchronize()
                stats["card_quantize_s"] = time.perf_counter() - t0
                ref4 = fuse_decoder_serving(quantize_decoder_params(
                    pipe.params["decoder"], bits=4, pack=True, group=0))
                ref4 = {"layers": {n: ref4["layers"][n]
                                   for n in ("wqkv", "wo", "w_gateup", "w_down")},
                        "lm_head": ref4["lm_head"]}
                # (e'') the bf16 kernel path's prefill logits and tokens on the
                # fp32 check's request, kept on the host
                fp32_in = fp32_request_inputs(cfg, videos[0])
                prefix, mask = pipe.encode_prefix(*fp32_in)
                bf16_ref = {"logits": first_logits(torch, pipe, prefix, mask, "auto").cpu()}
                del prefix, mask
                pipe.infer_events_batch(*fp32_in, max_new_tokens=CKPT_NEW)
                bf16_ref["tokens"] = pipe.last_stats["tokens"]
                del pipe
                gc.collect()
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            seconds, undo = timed_calls({
                "read_convert_s": (convert, "convert_trace_checkpoint"),
                "quantize_s": (pl, "int8_serving"),
                "upload_s": (pl.TracePipeline, "_prepare_memory_layout")})
            try:
                with HostPeak() as host:
                    t0 = time.perf_counter()
                    pipe = pl.model_init(str(ckpt), quant=quant, tokenizer=tok)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                undo()
            inits[quant] = {"model_init_s": wall, **seconds,
                            "host_peak_gib": host.peak,
                            "card_peak_gib": gib(torch.cuda.max_memory_allocated() - held),
                            "card_held_gib": gib(torch.cuda.memory_allocated() - held)}
            off = [n for n, t in tree_leaves({"p": pipe.params, "c": pipe._combined}).items()
                   if t.device.type != "cuda"]
            i = inits[quant]
            print(f"checkpoint ({quant}): model_init {wall:.1f} s (read + convert "
                  f"{i['read_convert_s']:.1f} s, quantize on the host {i['quantize_s']:.1f} s, "
                  f"upload and layout {i['upload_s']:.1f} s); host peak RSS "
                  f"{host.peak:.2f} GiB; card peak {i['card_peak_gib']:.2f} GiB during "
                  f"set-up, {i['card_held_gib']:.2f} held after; leaves off the card: "
                  f"{off or 'none'}", flush=True)
            if off:
                fail(f"checkpoint ({quant}): model_init left {off} off the card")
            if quant == "bf16":
                if reads != dict.fromkeys(manifest["keys"], 1):
                    bad = {k: reads.get(k, 0) for k in manifest["keys"] if reads.get(k, 0) != 1}
                    fail(f"checkpoint (a): keys not read exactly once: {list(bad.items())[:8]}")
                want = {n: (tuple(t.shape), t.dtype) for n, t in tree_leaves(init_trace_params(
                    cfg, torch.Generator(), device="meta")).items()}
                if captured["leaves"] != want:
                    diff = sorted(set(captured["leaves"].items()) ^ set(want.items()))
                    fail(f"checkpoint (a): converted leaves differ from init_trace_params: "
                         f"{diff[:6]}")
                for key, _, transform in CKPT_SAMPLES:
                    ref_t = transform(ckpt_value(torch, index[key], key, dict(keys)[key])).cpu()
                    if not torch.equal(captured["samples"][key].view(torch.int16),
                                       ref_t.contiguous().view(torch.int16)):
                        fail(f"checkpoint (a): the leaf of {key} is not the bytes written")
                print(f"checkpoint check (a): {len(reads)} keys read once each; "
                      f"{len(want)} leaves of init_trace_params' shapes and dtypes; "
                      f"{len(CKPT_SAMPLES)} sampled leaves bit-equal to the bytes written",
                      flush=True)
    finally:
        convert.load_checkpoint_tensors, convert.convert_trace_checkpoint = orig_load, orig_convert
    stats["model_init"] = inits

    # (b) the int8 decoder against (a)'s quantized on the card: q and s bit
    # for bit (both sides divide in IEEE fp32, round half to even, round the
    # scale to bf16 to nearest even)
    dec = pipe._decoder_params
    got = {**dec["layers"], "lm_head": dec["lm_head"]}
    want = {**ref["layers"], "lm_head": ref["lm_head"]}
    bits = {"q": torch.int8, "s": torch.int16}
    mismatched = [f"{n}/{part}" for n in want for part in ("q", "s")
                  if not torch.equal(got[n][part].view(bits[part]), want[n][part].view(bits[part]))]
    print(f"checkpoint check (b): the int8 decoder (host-quantized) against (a)'s quantized on "
          f"the card ({stats['card_quantize_s']:.1f} s): mismatched leaves "
          f"{mismatched or 'none'} (limit: bit-equal q and s); set-up peak "
          f"{inits['int8']['card_peak_gib']:.2f} GiB on the card against phase 5's 25.35 GiB "
          "quantizing on the card", flush=True)
    if mismatched:
        fail(f"checkpoint (b): host and card quantization differ in {mismatched}")
    del ref, dec, got, want
    torch.cuda.empty_cache()

    # (c) infer_events on an .npy video, then the same frames with the kernels
    # held; (d) the serving CLI's entry over the videos and the broken file
    stats["request"] = video_request(torch, pipe, cfg, videos[0], "(c)", CKPT_ROWS)
    launches = stats["request"]["launches"]
    stats["serve"] = serve_check(pipe, videos + [tmp / "broken.npy"], tmp / "serve.jsonl",
                                 "(d)", "broken")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # (b') int4: host-quantized per channel and nibble-packed, against (a)'s
    # decoder quantized to the group-0 tree on the card (bit for bit, as (b));
    # then a request on an .mp4 whose check (e) runs that card tree
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    seconds, undo = timed_calls({
        "read_convert_s": (convert, "convert_trace_checkpoint"),
        "quantize_s": (pl, "int4_serving"),
        "upload_s": (pl.TracePipeline, "_prepare_memory_layout")})
    try:
        with HostPeak() as host:
            t0 = time.perf_counter()
            pipe = pl.model_init(str(ckpt), quant="int4", tokenizer=tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        undo()
    dec = pipe._decoder_params
    i = inits["int4"] = {
        "model_init_s": wall, **seconds, "host_peak_gib": host.peak,
        "card_peak_gib": gib(torch.cuda.max_memory_allocated() - held),
        "card_held_gib": gib(torch.cuda.memory_allocated() - held),
        "decoder_gib": gib(sum(t.numel() * t.element_size() for t in tree_leaves(dec).values())),
        "act_quant": pipe.config.decoder.act_quant,
        "kv_cache_dtype": pipe.config.decoder.kv_cache_dtype}
    got = {**dec["layers"], "lm_head": dec["lm_head"]}
    want = {**ref4["layers"], "lm_head": ref4["lm_head"]}
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    mismatched = [f"{n}/{part}" for n in want for part in want[n]
                  if set(got[n]) != set(want[n]) or not torch.equal(bits(got[n][part]),
                                                                   bits(want[n][part]))]
    off = [n for n, t in tree_leaves({"p": pipe.params, "c": pipe._combined}).items()
           if t.device.type != "cuda"]
    print(f"checkpoint (int4): model_init {wall:.1f} s (read + convert "
          f"{i['read_convert_s']:.1f} s, quantize and pack on the host {i['quantize_s']:.1f} s, "
          f"upload and layout {i['upload_s']:.1f} s); host peak RSS {host.peak:.2f} GiB; card "
          f"peak {i['card_peak_gib']:.2f} GiB during set-up, {i['card_held_gib']:.2f} held after "
          f"(int8: {inits['int8']['card_held_gib']:.2f}), the decoder {i['decoder_gib']:.2f} GiB; "
          f"act_quant {i['act_quant']}, KV cache {i['kv_cache_dtype']}; leaves off the card: "
          f"{off or 'none'}", flush=True)
    print(f"checkpoint check (b'): the int4 decoder (host-quantized, packed per channel) "
          f"against (a)'s quantized on the card (bits=4, pack=True, group=0, fused): "
          f"mismatched leaves {mismatched or 'none'} (limit: bit-equal qp, q and s)", flush=True)
    if off or mismatched or i["act_quant"] or i["kv_cache_dtype"] != "int8":
        fail(f"checkpoint (b'): leaves off the card {off}, host and card quantization differ "
             f"in {mismatched}, or act_quant {i['act_quant']} / KV {i['kv_cache_dtype']} are "
             "not weight-only with the int8 cache")
    del got
    card_tree = {**dec, "layers": {**dec["layers"], **ref4["layers"]}, "lm_head": ref4["lm_head"]}
    stats["request_int4"] = video_request(torch, pipe, cfg, mp4s[1], "(b')",
                                              CKPT_INT4_ROWS, decoder=card_tree)
    del pipe, dec, card_tree, ref4, want
    gc.collect()
    torch.cuda.empty_cache()
    f32_launches, stats["fp32"] = fp32_checkpoint(torch, ckpt, cfg, tok, fp32_in, bf16_ref)
    stats["verify"] = verify_checkpoint(ckpt, tmp)
    launches = {**launches, **{k: n for k, n in f32_launches.items() if not launches.get(k)}}
    stats["container_reads"] = dict(CONTAINER_READS)
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"checkpoint: container reads by route {stats['container_reads']}; phase 7 took "
          f"{stats['seconds']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


# (e'') model_init(dtype=torch.float32): the fp32 kernel path's prefill logits
# no further from the fp32 plain path's than FP32_LOGITS_RATIO x the bf16
# kernel path's
FP32_LOGITS_RATIO = 0.1
FP32_CKPT_ROWS = {"flash_attention_f32", "vit_attention_btd_f32", "decode_attention_f32"}


def fp32_request_inputs(cfg, video: Path) -> tuple:
    """([frames], [timestamps], [instruction]) of (e'')'s request: one of
    phase 7's .npy videos sampled to the config's frames."""
    from trace_tpu_torch.video.io import load_video_frames

    frames, stamps = load_video_frames(str(video), cfg.num_frames)
    return [frames], [stamps], [CORPUS_ASK]


def fp32_checkpoint(torch, ckpt: Path, cfg, tok, inputs: tuple, bf16_ref: dict) -> tuple:
    """(e'') ``model_init(ckpt, dtype=torch.float32)`` on the 32-layer
    checkpoint (every earlier pipeline of the phase released): set-up s and
    peak GiB, the tree fp32 on the card; one request with no plain version on
    the card and only the fp32 forms of rows 1, 2 and 3 launched, with check
    (e) on its own inputs (its wall time includes the check's plain calls,
    one an entry and shape); then the
    prefill logits of the request's prefix through the kernels and through
    the plain versions (``attn_impl="plain"``, the encode too): the kernel
    path's distance from the plain path's at most FP32_LOGITS_RATIO x the
    bf16 kernel path's (``bf16_ref``, phase 7's bf16 pipeline on the same
    request); the greedy tokens' agreement with the bf16 path's, reported."""
    from trace_tpu_torch.runtime import pipeline as pl

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pipe = pl.model_init(str(ckpt), dtype=torch.float32, tokenizer=tok)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    dtypes = {str(t.dtype) for t in tree_leaves(pipe.params).values() if t.is_floating_point()}
    plain, undo = watch_plain(torch)
    reset_serving_launches()
    try:
        t0 = time.perf_counter()
        _, check_e = on_path(torch, "checkpoint fp32", lambda: pipe.infer_events_batch(
            *inputs, max_new_tokens=CKPT_NEW))
        wall = time.perf_counter() - t0
    finally:
        undo()
    got = {k: v for k, v in serving_launches().items() if v}
    ran_plain = {k: v for k, v in plain.items() if v}
    s = pipe.last_stats
    steps = s["decode_steps"]
    tokens = s["tokens"]
    prefix, mask = pipe.encode_prefix(*inputs)
    kernel = first_logits(torch, pipe, prefix, mask, "auto")
    chunked = chunked_prefill_check(torch, pipe, "fp32 checkpoint", CHUNK_TOL_F32,
                                    encoded=(prefix, mask))
    del prefix, mask
    pipe.attn_impl = "plain"
    prefix, mask = pipe.encode_prefix(*inputs)
    plain_logits = first_logits(torch, pipe, prefix, mask, "plain")
    del prefix, mask, pipe
    torch.cuda.empty_cache()
    d32 = ((kernel - plain_logits).norm() / plain_logits.norm()).item()
    d16 = ((bf16_ref["logits"].cuda() - plain_logits).norm() / plain_logits.norm()).item()
    a, b = tokens[0], bf16_ref["tokens"][0]
    n = min(len(a), len(b))
    agree = sum(int(x == y) for x, y in zip(a[:n], b[:n])) / max(n, 1)
    prefix_agree = next((i for i in range(n) if a[i] != b[i]), n)
    out = {"model_init_s": init_s, "card_peak_gib": peak,
           "card_held_gib": (torch.cuda.memory_allocated() - held) / 2 ** 30,
           "dtypes": sorted(dtypes), "request_wall_s": wall, "encode_s": s["encode_s"],
           "prefill_s": s["prefill_s"], "decode_ms_per_step": 1e3 * s["decode_s"] / max(steps, 1),
           "prefix_tokens": s["prefix_tokens"], "launches": got,
           "logits_fp32_kernel_vs_plain": d32, "logits_bf16_kernel_vs_fp32_plain": d16,
           "greedy_agreement_with_bf16": agree, "greedy_equal_prefix_with_bf16": prefix_agree,
           "chunked_prefill": chunked, "check_e": check_e}
    print(f"checkpoint (e''): model_init(dtype=float32) {init_s:.1f} s, card peak {peak:.2f} GiB "
          f"during set-up, float dtypes on the card {sorted(dtypes)}; one request: wall "
          f"{wall:.2f} s, encode {s['encode_s']:.3f} s, prefill {s['prefill_s']:.3f} s, decode "
          f"{out['decode_ms_per_step']:.2f} ms/step over {steps} steps; launches {got}; plain "
          f"versions on the card {ran_plain or 'none'}; prefill logits from the fp32 plain "
          f"path's (||diff|| / ||ref||): fp32 kernels {d32:.3g}, bf16 kernels {d16:.3g} (limit "
          f"fp32 <= {FP32_LOGITS_RATIO} x bf16); greedy tokens equal the bf16 path's in "
          f"{agree:.3f} of {n}, the first {prefix_agree}", flush=True)
    if (dtypes != {"torch.float32"} or set(got) != FP32_CKPT_ROWS or ran_plain or steps <= 0
            or not torch.isfinite(kernel).all() or not d32 <= FP32_LOGITS_RATIO * d16):
        fail("checkpoint (e''): the fp32 pipeline's tree, launches, plain versions or prefill "
             "logits are not as expected")
    return got, out


def verify_checkpoint(ckpt: Path, tmp: Path) -> dict:
    """(f) ``python -m trace_tpu_torch.checkpoint.manifest --verify`` on the
    checkpoint: exit 0; on a directory of links to it that leaves out one
    shard: a nonzero exit and MISSING lines."""
    import shutil

    cut = tmp / "trace-7b-cut"
    cut.mkdir()
    shards = sorted(ckpt.glob("*.safetensors"))
    for f in ckpt.iterdir():
        if f != shards[-1]:
            (cut / f.name).symlink_to(f)
    repo = Path(__file__).resolve().parent
    start = lambda d: subprocess.Popen(
        [sys.executable, "-m", "trace_tpu_torch.checkpoint.manifest", "--verify", str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=repo)
    t0 = time.perf_counter()
    procs = [start(ckpt), start(cut)]  # both at once

    def finish(p):
        out, err = p.communicate(timeout=300)
        return subprocess.CompletedProcess(p.args, p.returncode, out, err)

    whole, broken = (finish(p) for p in procs)
    seconds = time.perf_counter() - t0
    missing = sum(line.startswith("MISSING ") for line in broken.stdout.splitlines())
    out = {"rc": whole.returncode, "seconds": seconds, "last_line": whole.stdout.strip()[-200:],
           "cut_rc": broken.returncode, "cut_missing_lines": missing,
           "cut_shard": shards[-1].name}
    print(f"checkpoint (f): manifest --verify exit {whole.returncode} ({seconds:.1f} s, both "
          f"runs) ({out['last_line']!r}); without {shards[-1].name}: exit "
          f"{broken.returncode}, {missing} MISSING lines", flush=True)
    if whole.returncode != 0 or broken.returncode == 0 or not missing:
        fail(f"checkpoint (f): manifest --verify: {whole.stdout[-1500:]} {whole.stderr[-1500:]}")
    shutil.rmtree(cut)
    return out


def runbook(torch, tmp: Path) -> int:
    """``--runbook``: scripts/parity/run_all_torch.sh on a TRACE-7B
    checkpoint written by phase 7's writer (its 690 keys, random values, no
    tokenizer files) with one of phase 7's .npy videos; its output and exit
    code. Stages 0-3 run; stage 4 (quality eval) has no annotations here and
    prints SKIP."""
    import numpy as np

    from trace_tpu_torch.model.config import TraceConfig

    manifest = json.loads((Path(__file__).resolve().parent / CKPT_MANIFEST).read_text())
    keys = [(k, tuple(v)) for k, v in manifest["keys"].items()]
    ckpt = tmp / "trace-7b"
    t0 = time.perf_counter()
    write_checkpoint(torch, ckpt, keys, TraceConfig())
    video = tmp / "video0.npy"
    np.save(video, np.random.default_rng(SEED).integers(
        0, 256, (CKPT_VIDEO_FRAMES,) + CORPUS_HW + (3,), dtype=np.uint8))
    print(f"runbook: checkpoint and video written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run(["bash", "scripts/parity/run_all_torch.sh", str(ckpt), "--video",
                        str(video)], cwd=Path(__file__).resolve().parent, text=True,
                       capture_output=True, timeout=1800)
    print(r.stdout[-12000:], r.stderr[-4000:], sep="\n", flush=True)
    print(f"runbook: run_all_torch.sh exit {r.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return r.returncode


# Phase 8: the evaluation entry points (``trace_tpu_torch.eval``,
# ``runtime.inference``) at full width, in phase 7's directory: its .npy
# videos, four more of the kind beside them, and a checkpoint of phase 7's
# layout at EVAL_LAYERS of the 32 decoder layers. The eval layer takes the
# depth from config.json and nothing else of it; phase 7's 32-layer
# checkpoint holds the layout's checks, and at 32 layers here the host-paced
# decode and conversions put the whole smoke at 1165 s (an H100 80GB HBM3 at
# 700 W).
EVAL_LAYERS = 8
# .npy videos of 256 640x360 frames: phase 7's 4 (8 before the .mp4 checks
# came: cut to keep the whole smoke well inside its 1200 s)
EVAL_VIDEOS = 4
EVAL_NEW = 64             # --max-new-tokens of every run
EVAL_BATCH = 4            # the eval CLI's --batch-size default
EVAL_DURATION = round(CKPT_VIDEO_FRAMES / 30.0, 3)  # an .npy plays at 30 fps
EVAL_ROWS = {"bf16": ("flash_attention", "vit_attention_btd", "decode_attention"),
             "int8": CKPT_ROWS}
# the top-level keys of score_results for each task on eval_ground_truth's
# annotations, as the JAX package's score_results returns them
# (tests/test_torch_eval.py holds the two alike)
EVAL_SCORE_KEYS = {
    "tvg": ("R@0.3", "R@0.5", "R@0.7", "mIoU", "num_queries"),
    "dvc": ("Para_CIDER", "Para_METEOR", "CIDER", "METEOR", "SODA_c_3", "Precision@0.3",
            "Recall@0.3", "Precision@0.5", "Recall@0.5", "Precision@0.7", "Recall@0.7",
            "Precision@0.9", "Recall@0.9", "Precision_Mean", "Recall_Mean", "F1_Score",
            "n_preds", "meteor_is_approximate"),
    "dvc-anet": ("Precision", "Recall", "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L",
                 "CIDEr", "METEOR", "F1", "meteor_is_approximate"),
    "vhd": ("brief", "HL-min-Fair", "HL-min-Good", "HL-min-VeryGood"),
}
# MVBench "Episodic Reasoning": TVQA clips dumped as 3-fps JPEG frames
# (name, frames), and its records (clip, question, candidates, answer,
# [start, end] or None)
EVAL_CLIPS = (("s01e02_seg02_clip_07", 180), ("s05e14_seg01_clip_03", 120))
EVAL_MCQA = (
    ("s01e02_seg02_clip_07", "Where was Sheldon when he spoke to Leonard?",
     ["In the kitchen.", "At the office.", "On the stairs.", "In the car.", "At the cafe."],
     "On the stairs.", (3.0, 41.5)),
    ("s01e02_seg02_clip_07", "What did Penny hold when she came in?",
     ["A cup.", "A book.", "A bag.", "A phone.", "Nothing."], "A bag.", None),
    ("s05e14_seg01_clip_03", "Why did Howard leave the room?",
     ["He was angry.", "He got a call.", "He was late.", "He felt sick.", "He was asked to."],
     "He got a call.", (10.0, 30.0)),
    ("s05e14_seg01_clip_03", "Who sat down first?",
     ["Raj.", "Amy.", "Howard.", "Bernadette.", "Sheldon."], "Amy.", (0.0, 40.0)),
)
# MVBench "Action Sequence": Charades clips as .mp4 (name, frames at
# CKPT_MP4_FPS), and its records, each with its [start, end]
EVAL_MP4_CLIPS = (("0A8CF", 120), ("1B2ZQ", 90))
EVAL_MP4_MCQA = (
    ("0A8CF.mp4", "What happened after the person took the cup?",
     ["Put down the cup.", "Opened the door.", "Sat on the bed.", "Took the book."],
     "Put down the cup.", (0.5, 4.2)),
    ("1B2ZQ.mp4", "What did the person do first?",
     ["Opened the box.", "Closed the window.", "Held the phone.", "Ate the food."],
     "Held the phone.", (0.0, 3.6)),
)
# Video-MME: phase 7's .mp4 files under YouTube-style ids, and its records
# (video id, duration category, question, options, answer)
EVAL_VIDEOMME = (
    ("fFjv93ACGo8", "video0.mp4", "short", "What is the main object in the video?",
     ["A. A ball.", "B. A car.", "C. A dog.", "D. A cup."], "B"),
    ("fFjv93ACGo8", "video0.mp4", "short", "How does the scene change?",
     ["A. It darkens.", "B. It stays.", "C. It pans left.", "D. It zooms in."], "D"),
    ("zz9xJrPPpW0", "video1.mp4", "medium", "What does the person do first?",
     ["A. Chop.", "B. Stir.", "C. Pour.", "D. Taste."], "A"),
)


def eval_ground_truth(names) -> dict:
    """Annotations over the videos ``names`` in each task's
    {split}.caption_coco_format.json schema (trace_tpu_torch/eval/evaluate.py):
    ``tvg`` a query window a video; ``dvc`` two captioned segments a video,
    which also serve ``dvc-anet``; ``vhd`` a window, three annotators'
    saliency on 2-s clips. Within EVAL_DURATION; no randomness."""
    d = EVAL_DURATION
    out = {"tvg": [], "dvc": [], "vhd": []}
    for i, name in enumerate(names):
        a = round(0.4 + 0.3 * (i % 5), 2)
        b = round(min(d, a + 2.5 + 0.5 * (i % 3)), 2)
        base = {"image_id": f"clips/{name}", "id": i, "duration": d}
        out["tvg"].append({**base, "caption": f"a person does action number {i}",
                           "timestamp": [a, b]})
        out["dvc"].append({**base, "segments": [[a, b], [b, d]],
                           "caption": f"A person picks up the object number {i}. The "
                                      "person puts it down on the table."})
        out["vhd"].append({**base, "caption": f"a person does action number {i}",
                           "segments": [[a, b]], "relevant_clip_ids": [0, 1, 2],
                           "saliency_scores": [[(i + k) % 5, (i + 2 * k) % 5, (i + 3 * k) % 5]
                                               for k in range(3)]})
    return out


def all_finite(x) -> bool:
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(all_finite(v) for v in x)
    return isinstance(x, (bool, int)) or (isinstance(x, float) and math.isfinite(x))


def check_scores(task: str, scores: dict, seconds: float) -> None:
    keys = EVAL_SCORE_KEYS[task]
    print(f"eval: score_results {task} in {seconds:.3f} s: "
          + ", ".join(f"{k}={scores[k]}" for k in keys if k in scores and k != "brief"),
          flush=True)
    if set(scores) != set(keys) or not all_finite(scores):
        fail(f"eval: score_results {task} gave keys {sorted(scores)} (want {sorted(keys)}) "
             "or a value that is not finite")


def eval_phase(torch, tmp: Path, container_route: str) -> tuple:
    """Phase 8, in phase 7's directory ``tmp``, on a checkpoint of phase 7's
    layout at EVAL_LAYERS decoder layers written here: (a) ``eval.evaluate.main`` for
    task tvg with the CLI's defaults (bf16, 128 frames, batch 4) over 4 .npy
    videos, a missing file, one with a corrupt header (.npy) and a junk .mp4
    (the one container that fails, filtered before the run);
    (b) ``model_init(quant="int8")``, ``run_vtg_eval`` for dvc streamed at
    batch 4, then ``score_results`` for dvc, dvc-anet and vhd; (c)
    ``run_mvbench`` with (b)'s pipeline on the frame-directory subtask and a
    "video" subtask of .mp4 clips with bounds; (e) ``run_videomme`` with
    (b)'s pipeline over phase 7's .mp4 files; (d)
    ``runtime.inference.main`` on one .npy. Checks: a record per readable
    video and none else, the fmt file equal to the records; every score of
    the JAX package's keys and finite; in each run the path's rows launched
    (1, 2, 3; 1, 2, 3b, 4, 5; (d) 1, 2, 3), no plain version on the card,
    and each kernel, the first call at each shape, held to its plain
    version (check (e) of phase 5); accuracies in [0, 100] with no failure,
    each .mp4 read on ``container_route``; (d)'s events finite.
    ``model_init`` gets ``SpmLikeTokenizer``: the checkpoint has no
    tokenizer files."""
    import gc
    import os

    import numpy as np
    from PIL import Image

    import trace_tpu_torch
    from trace_tpu_torch.eval import evaluate, mcqa
    from trace_tpu_torch.metrics import captioning, meteor_align
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime import inference
    from trace_tpu_torch.runtime import pipeline as pl
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.video.io import CONTAINER_READS

    t_phase = time.perf_counter()
    manifest = json.loads((Path(__file__).resolve().parent / CKPT_MANIFEST).read_text())
    keys = [(k, tuple(v)) for k, v in manifest["keys"].items()
            if not k.startswith("model.layers.") or int(k.split(".")[2]) < EVAL_LAYERS]
    cfg = TraceConfig()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               num_layers=EVAL_LAYERS))
    ckpt = tmp / "trace-7b-eval"
    nbytes = write_checkpoint(torch, ckpt, keys, cfg)
    ckpt = str(ckpt)
    stats = {"container_reader": container_route, "layers": EVAL_LAYERS}
    print(f"eval: phase 7's layout at {EVAL_LAYERS} of 32 decoder layers ({len(keys)} keys, "
          f"{nbytes / 1e9:.2f} GB of bf16) written in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED + 8)
    for v in range(CKPT_VIDEOS, EVAL_VIDEOS):  # phase 7 wrote video0..CKPT_VIDEOS-1
        np.save(tmp / f"video{v}.npy", rng.integers(
            0, 256, (CKPT_VIDEO_FRAMES,) + CORPUS_HW + (3,), dtype=np.uint8))
    names = [f"video{v}.npy" for v in range(EVAL_VIDEOS)]
    (tmp / "junk.mp4").write_bytes(b"not a video container")
    gt = eval_ground_truth(names)
    bad = [{"image_id": f"clips/{n}", "id": 100 + k, "caption": "a query",
            "timestamp": [0.0, 1.0], "duration": EVAL_DURATION}
           for k, n in enumerate(("missing.npy", "broken.npy", "junk.mp4"))]
    anno = {}
    for task in ("tvg", "dvc", "vhd"):
        anno[task] = tmp / f"anno_{task}"
        anno[task].mkdir()
        records = gt[task] + (bad if task == "tvg" else [])
        (anno[task] / "test.caption_coco_format.json").write_text(
            json.dumps({"annotations": records}))

    tok = SpmLikeTokenizer()
    orig_init, orig_generate = pl.model_init, gen.generate
    steps = {"steps": 0, "decode_s": 0.0}

    def counting_generate(*a, **k):
        out = orig_generate(*a, **k)
        steps["steps"] += out.decode_steps
        steps["decode_s"] += out.phase_times["decode_s"]
        return out

    built = {}  # the pipeline the last model_init built, until read

    def init(path, **k):
        built["pipe"] = orig_init(path, tokenizer=tok, **k)
        return built["pipe"]

    pl.model_init = trace_tpu_torch.model_init = init
    gen.generate = counting_generate
    meteor = captioning.make_meteor()
    stats["meteor"] = type(meteor).__name__
    meteor.close()
    stats["stemmer"] = type(meteor_align._porter()).__name__
    print(f"eval: METEOR {stats['meteor']} (approximate: "
          f"{getattr(meteor, 'approximate', False)}), stemmer {stats['stemmer']}; video "
          f"containers read through {container_route}; model_init takes SpmLikeTokenizer",
          flush=True)

    def run(label, mode, fn):
        """``fn()`` with the launches counted, plain versions watched and
        the kernels held (on_path); prints and checks."""
        reset_serving_launches()
        steps.update(steps=0, decode_s=0.0)
        plain_counts, undo = watch_plain(torch)
        try:
            t0 = time.perf_counter()
            out, held = on_path(torch, f"eval {label}", fn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            undo()
        launches = serving_launches()
        plain = {k: v for k, v in plain_counts.items() if v}
        idle = [r for r in EVAL_ROWS[mode] if launches[r] <= 0]
        ms = 1e3 * steps["decode_s"] / max(steps["steps"], 1)
        r = {"wall_s": wall, "decode_steps": steps["steps"], "ms_per_step": ms,
             "launches": {k: v for k, v in launches.items() if v}, "on_path": held}
        print(f"eval ({label}, {mode}): wall {wall:.2f} s, {steps['steps']} decode steps at "
              f"{ms:.2f} ms/step; launches {r['launches']}; plain versions on the card: "
              f"{plain or 'none'}", flush=True)
        if idle or plain:
            fail(f"eval ({label}): rows {idle} not launched, plain versions {plain} on the card")
        return out, r

    def corpus_line(label, pipe, n_records, seconds):
        cs = dict(pipe.last_corpus_stats, videos_per_s=n_records / seconds)
        print(f"eval ({label}): run_vtg_eval {seconds:.2f} s, {n_records} records, "
              f"{cs['videos_per_s']:.4f} videos/s (check (e) inside); last_corpus_stats "
              f"{pipe.last_corpus_stats}", flush=True)
        return cs

    try:
        # (a) the eval CLI, in-process
        captured = {}
        orig_run = evaluate.run_vtg_eval

        def capturing(*a, **k):
            t0 = time.perf_counter()
            captured["results"] = orig_run(*a, **k)
            captured["s"] = time.perf_counter() - t0
            return captured["results"]

        evaluate.run_vtg_eval = capturing
        seconds, undo_timed = timed_calls({"tvg": (evaluate, "score_results")})
        out_dir = tmp / "eval_out"
        argv = ["--model-path", ckpt, "--task", "tvg", "--anno-path", str(anno["tvg"]),
                "--video-path", str(tmp), "--output-dir", str(out_dir),
                "--max-new-tokens", str(EVAL_NEW)]
        try:
            scores, stats["a"] = run("a", "bf16", lambda: evaluate.main(argv))
        finally:
            evaluate.run_vtg_eval = orig_run
            undo_timed()
        results = captured["results"]
        fmt = out_dir / "fmt_tvg_test_f128.json"
        got_ids = [r["id"] for r in results]
        print(f"eval check (a): evaluate.main wrote {fmt.name}; records for ids {got_ids} "
              f"(of {len(gt['tvg'])} readable videos, a missing file, a corrupt .npy, a junk "
              ".mp4)", flush=True)
        if (got_ids != [j["id"] for j in gt["tvg"]]
                or json.loads(fmt.read_text()) != json.loads(json.dumps(results))):
            fail("eval (a): not one record per readable video, or the fmt file is not the "
                 "records")
        stats["a"]["run_vtg_eval_s"] = captured["s"]
        stats["a"]["corpus"] = corpus_line("a", built.pop("pipe"), len(results), captured["s"])
        check_scores("tvg", scores, seconds["tvg"])
        stats["a"]["score_s"] = seconds["tvg"]
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the single-video demo, bf16 as its model_init
        saved_env = {k: os.environ.get(k) for k in ("MODEL_PATH", "MAX_NEW_TOKENS", "FRAMES")}
        os.environ.update(MODEL_PATH=ckpt, MAX_NEW_TOKENS=str(EVAL_NEW))
        os.environ.pop("FRAMES", None)
        try:
            events, stats["d"] = run("d", "bf16", lambda: inference.main(
                ["inference", str(tmp / names[0])]))
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        built.pop("pipe")
        n_ev = len(events["timestamps"])
        print(f"eval check (d): inference.main on {names[0]} (64 frames, the script's "
              f"default): {n_ev} events, {len(events['captions'])} captions", flush=True)
        if set(events) != {"timestamps", "scores", "captions"} or not all_finite(
                [events["timestamps"], events["scores"]]):
            fail(f"eval (d): inference.main printed {sorted(events)} or values not finite")
        gc.collect()
        torch.cuda.empty_cache()

        # (b) int8: dvc streamed at batch 4, scored three ways
        t0 = time.perf_counter()
        pipe = pl.model_init(ckpt, quant="int8")
        built.pop("pipe")
        torch.cuda.synchronize()
        stats["int8_model_init_s"] = time.perf_counter() - t0
        dvc_anno = evaluate.load_annotations(str(anno["dvc"]), "test")
        results, stats["b"] = run("b", "int8", lambda: evaluate.run_vtg_eval(
            pipe, "dvc", dvc_anno, str(tmp), batch_size=EVAL_BATCH, streamed=True,
            max_new_tokens=EVAL_NEW))
        stats["b"]["corpus"] = corpus_line("b", pipe, len(results), stats["b"]["wall_s"])
        if [r["id"] for r in results] != [j["id"] for j in dvc_anno]:
            fail("eval (b): not one record per video")
        stats["b"]["score_s"] = {}
        for task, gt_task in (("dvc", "dvc"), ("dvc-anet", "dvc"), ("vhd", "vhd")):
            t0 = time.perf_counter()
            scores = evaluate.score_results(
                task, results, str(anno[gt_task] / "test.caption_coco_format.json"))
            stats["b"]["score_s"][task] = time.perf_counter() - t0
            check_scores(task, scores, stats["b"]["score_s"][task])

        route = container_route.split()[0]

        def mcqa_check(label, final, dump, n_items, groups, reads_before, n_mp4):
            read = {k: CONTAINER_READS[k] - reads_before[k] for k in reads_before}
            print(f"eval check ({label}): {final}; {len(dump['res_list'])} answers; "
                  f"container reads {read}", flush=True)
            accs = [v for k, v in final.items() if k != "num_failures"]
            if (final["num_failures"] != 0 or len(dump["res_list"]) != n_items
                    or set(final) != {*groups, "Avg", "num_failures"}
                    or not all(0.0 <= v <= 100.0 for v in accs)
                    or read != {**dict.fromkeys(read, 0), route: n_mp4}):
                fail(f"eval ({label}): an item failed, an accuracy lies outside [0, 100], or "
                     f"the .mp4 items were not read on the {route} route ({read})")

        # (c) MVBench's frame-directory subtask and a "video" one in .mp4
        # clips, with (b)'s pipeline
        root = tmp / "mvbench"
        frames_dir = root / "video" / mcqa.MVBENCH_TASKS["Episodic Reasoning"][1]
        base = rng.integers(0, 256, CORPUS_HW + (3,), dtype=np.uint8)
        for clip, n in EVAL_CLIPS:
            (frames_dir / clip).mkdir(parents=True)
            for i in range(1, n + 1):  # 00001.jpg ...: 3-fps dumps, 1-indexed
                Image.fromarray(np.roll(base, 8 * i, axis=1)).save(
                    frames_dir / clip / f"{i:05d}.jpg", quality=90)
        clips_dir = root / "video" / mcqa.MVBENCH_TASKS["Action Sequence"][1]
        clips_dir.mkdir(parents=True)
        for clip, n in EVAL_MP4_CLIPS:
            write_mp4(clips_dir / f"{clip}.mp4",
                      np.stack([np.roll(base, -6 * i, axis=0) for i in range(n)]))
        (root / "json").mkdir()
        (root / "json" / mcqa.MVBENCH_TASKS["Episodic Reasoning"][0]).write_text(json.dumps([
            {"video": clip, "question": q, "candidates": c, "answer": a,
             **({"start": b[0], "end": b[1]} if b else {})}
            for clip, q, c, a, b in EVAL_MCQA]))
        (root / "json" / mcqa.MVBENCH_TASKS["Action Sequence"][0]).write_text(json.dumps([
            {"video": clip, "question": q, "candidates": c, "answer": a, "start": b[0],
             "end": b[1]} for clip, q, c, a, b in EVAL_MP4_MCQA]))
        reads = dict(CONTAINER_READS)
        final, stats["c"] = run("c", "int8", lambda: mcqa.run_mvbench(
            pipe, str(root / "json"), str(root / "video"), num_frames=128,
            batch_size=EVAL_BATCH, max_new_tokens=EVAL_NEW, output_dir=str(root / "out"),
            tasks=["Episodic Reasoning", "Action Sequence"]))
        stats["c"]["final"] = final
        mcqa_check("c", final, json.loads((root / "out" / "test.json").read_text()),
                   len(EVAL_MCQA) + len(EVAL_MP4_MCQA), ("Episodic Reasoning", "Action Sequence"),
                   reads, len(EVAL_MP4_MCQA))

        # (e) Video-MME over phase 7's .mp4 files, with (b)'s pipeline
        vmme = tmp / "videomme"
        (vmme / "data").mkdir(parents=True)
        for vid, src, *_ in EVAL_VIDEOMME:
            if not (vmme / "data" / f"{vid}.mp4").exists():
                os.link(tmp / src, vmme / "data" / f"{vid}.mp4")
        (vmme / "videomme.json").write_text(json.dumps([
            {"videoID": vid, "duration": dur, "question_id": f"{vid}-{k}", "question": q,
             "options": opts, "answer": a}
            for k, (vid, _, dur, q, opts, a) in enumerate(EVAL_VIDEOMME)]))
        reads = dict(CONTAINER_READS)
        final, stats["e"] = run("e", "int8", lambda: mcqa.run_videomme(
            pipe, str(vmme / "videomme.json"), str(vmme), num_frames=128,
            batch_size=EVAL_BATCH, max_new_tokens=EVAL_NEW, output_dir=str(vmme / "out")))
        stats["e"]["final"] = final
        mcqa_check("e", final, json.loads((vmme / "out" / "test.json").read_text()),
                   len(EVAL_VIDEOMME), {d for _, _, d, *_ in EVAL_VIDEOMME}, reads,
                   len(EVAL_VIDEOMME))
        del pipe
    finally:
        pl.model_init = trace_tpu_torch.model_init = orig_init
        gen.generate = orig_generate
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"eval: phase 8 took {stats['seconds']:.1f} s", flush=True)
    return stats


# Phase 9: the other two backbones the JAX package builds, at full width,
# each from a merged checkpoint written here (phase 7's writer, random bf16
# values) and loaded through ``model_init``: qwen2-7B (28 layers, D 3584,
# 28 / 4 heads, so G = 7, I 18944, vocab 152064, q / k / v biases) with
# CLIP ViT-L/14-336 and spatial_slot at 128 frames, served in bf16 and in
# int8 (int8 weights, left unfused by the biases; int8 KV cache; W8A8
# prefill); vicuna-7B (MHA, I 11008, vocab 32000) with stc_connector_v35,
# served in bf16. stc_connector_v35 halves the frames and the 24 x 24 patch
# grid: 72 tokens a frame, in the global-pooling layout (no time tokens).
# The video span of the prompt is frames x (num_slots + 6) positions, so
# num_slots 66 makes it hold them exactly; 32 frames keep the prefix at 2304
# video tokens (the plain attention of the reference check holds [B, H, T, T]
# scores).
FAMILY_MODES = ("qwen2 bf16", "qwen2 int8", "vicuna bf16", "openllama bf16", "openllama int8",
                "falcon3 bf16", "falcon3 int8")
# the backbones' decoder depth: every layer runs the same shapes at full
# width, and full depth beside phase 5's 32 layers and phase 11 put the whole
# smoke at 1098 s of the 1200; 8 (PR 18) at 1048 s with PR 20's fp32 checks
FAMILY_LAYERS = 4
VICUNA_FRAMES = 32
VICUNA_SLOTS = 66
FAMILY_ROWS = {"qwen2 bf16": {"decode_attention": "decode_attention_g7"},
               "qwen2 int8": {"decode_attention_int8_s8dot": "decode_attention_int8_s8dot_g7",
                              "decode_attention_int8_dequant": "decode_attention_int8_dequant_g7"},
               "openllama bf16": {"flash_attention": "flash_attention_hd100",
                                  "decode_attention": "decode_attention_hd100"},
               "openllama int8": {
                   "decode_attention_int8_s8dot": "decode_attention_int8_s8dot_hd100",
                   "decode_attention_int8_dequant": "decode_attention_int8_dequant_hd100"},
               "falcon3 bf16": {"flash_attention": "flash_attention_hd256",
                                "decode_attention": "decode_attention_hd256"},
               "falcon3 int8": {
                   "decode_attention_int8_s8dot": "decode_attention_int8_s8dot_hd256",
                   "decode_attention_int8_dequant": "decode_attention_int8_dequant_hd256"}}
# A decoder shaped like open_llama_3b: the decoder fields of the config.json
# of openlm-research/open_llama_3b (hidden 3200, 32 heads: hd 100) at
# FAMILY_LAYERS of its 26 layers. The published file has no
# num_key_value_heads, which both packages would default to 8; the model
# has 32 (MHA), written here.
OPEN_LLAMA_3B = {"model_type": "llama", "hidden_size": 3200, "intermediate_size": 8640,
                 "num_hidden_layers": 26, "num_attention_heads": 32, "num_key_value_heads": 32,
                 "vocab_size": 32000, "rms_norm_eps": 1e-6, "rope_theta": 10000.0}
HD_LORA_LAYERS = 2  # depth of its lora step and Falcon3's (rows 8-10 at hd 100, 256)
# A decoder shaped like Falcon3-7B: the decoder fields of the config.json of
# tiiuae/Falcon3-7B-Base (a LlamaForCausalLM checkpoint; hidden 3072, 12 / 4
# heads of head_dim 256, G = 3) at FAMILY_LAYERS of its 28 layers, with its
# published vocabulary as the other families take theirs.
FALCON3_7B = {"model_type": "llama", "hidden_size": 3072, "intermediate_size": 23040,
              "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 4,
              "head_dim": 256, "vocab_size": 131072, "rms_norm_eps": 1e-6,
              "rope_theta": 1000042.0}


def family_keys(cfg, vision_keys) -> list:
    """(key, shape) of a merged checkpoint of ``cfg`` in the HF layout: the
    decoder (q / k / v biases with ``attn_qkv_bias``), its heads, the
    connector (spatial_slot, or the STC family's timm names), the towers,
    and ``vision_keys`` (the bundled CLIP tower). A Mixtral-family decoder
    (``num_experts``) has a ``block_sparse_moe`` a layer in place of the MLP:
    the router ``gate`` [E, D] and each expert's w1 / w3 [I, D] and w2
    [D, I]."""
    d = cfg.decoder
    D, NQ, NKVW, I = d.hidden_size, d.num_heads * d.head_dim, d.num_kv_heads * d.head_dim, \
        d.intermediate_size
    keys = [("model.embed_tokens.weight", (d.vocab_size, D))]
    for i in range(d.num_layers):
        lyr = f"model.layers.{i}."
        keys += [(lyr + "input_layernorm.weight", (D,)),
                 (lyr + "post_attention_layernorm.weight", (D,)),
                 (lyr + "self_attn.q_proj.weight", (NQ, D)),
                 (lyr + "self_attn.k_proj.weight", (NKVW, D)),
                 (lyr + "self_attn.v_proj.weight", (NKVW, D)),
                 (lyr + "self_attn.o_proj.weight", (D, NQ))]
        if hasattr(d, "num_experts"):
            moe = lyr + "block_sparse_moe."
            keys.append((moe + "gate.weight", (d.num_experts, D)))
            for j in range(d.num_experts):
                keys += [(f"{moe}experts.{j}.w1.weight", (I, D)),
                         (f"{moe}experts.{j}.w3.weight", (I, D)),
                         (f"{moe}experts.{j}.w2.weight", (D, I))]
        else:
            keys += [(lyr + "mlp.gate_proj.weight", (I, D)),
                     (lyr + "mlp.up_proj.weight", (I, D)),
                     (lyr + "mlp.down_proj.weight", (D, I))]
        if d.attn_qkv_bias:
            keys += [(lyr + "self_attn.q_proj.bias", (NQ,)),
                     (lyr + "self_attn.k_proj.bias", (NKVW,)),
                     (lyr + "self_attn.v_proj.bias", (NKVW,))]
    keys += [("model.norm.weight", (D,)), ("lm_head.weight", (d.vocab_size, D)),
             ("sync_head.weight", (1, D)), ("time_head.weight", (d.time_vocab_size, D)),
             ("score_head.weight", (d.score_vocab_size, D))]
    mm, pre = cfg.vision.hidden_size, "model.mm_projector."
    if cfg.mm_projector_type == "spatial_slot":
        keys += [(pre + "slots", (mm, cfg.num_slots)), (pre + "ln_vision.weight", (mm,)),
                 (pre + "ln_vision.bias", (mm,)), (pre + "readout.weight", (D, mm))]
    else:  # stc_connector_v35: RegStages of 4 blocks around a 2 x 2 x 2 Conv3d
        for stage, first_in in (("s1", mm), ("s2", D)):
            for b in range(4):
                blk, cin = f"{pre}{stage}.b{b + 1}.", first_in if b == 0 else D
                rd = round(cin * 0.25)
                keys += [(blk + "conv1.conv.weight", (D, cin, 1, 1)),
                         (blk + "conv2.conv.weight", (D, 1, 3, 3)),
                         (blk + "conv3.conv.weight", (D, D, 1, 1)),
                         (blk + "se.fc1.weight", (rd, D, 1, 1)), (blk + "se.fc1.bias", (rd,)),
                         (blk + "se.fc2.weight", (D, rd, 1, 1)), (blk + "se.fc2.bias", (D,))]
                keys += [(f"{blk}conv{n}.bn.{w}", (D,)) for n in (1, 2, 3)
                         for w in ("weight", "bias")]
                if cin != D:
                    keys += [(blk + "downsample.conv.weight", (D, cin, 1, 1)),
                             (blk + "downsample.bn.weight", (D,)),
                             (blk + "downsample.bn.bias", (D,))]
        keys += [(pre + "sampler.0.weight", (D, D, 2, 2, 2)), (pre + "sampler.0.bias", (D,)),
                 (pre + "readout.0.weight", (D, D)), (pre + "readout.0.bias", (D,)),
                 (pre + "readout.2.weight", (D, D)), (pre + "readout.2.bias", (D,))]
    keys += [("model.time_tower.embed_tokens.weight", (d.time_vocab_size, D)),
             ("model.score_tower.embed_tokens.weight", (d.score_vocab_size, D)),
             ("model.sync_tower.embed_tokens.weight", (1, D))]
    return keys + list(vision_keys)


def serving_tree(pipe) -> dict:
    """A pipeline's tree on the card with the decoder's text embedding back
    (the combined table's first rows, a view), for another pipeline."""
    V = pipe.config.decoder.vocab_size
    return {**pipe.params, "decoder": {**pipe.params["decoder"], "embed": pipe._combined[:V]}}


def families_phase(torch, tmp: Path) -> tuple:
    """Phase 9 (see FAMILY_MODES). Per backbone: the checkpoint written, then
    per configuration ``model_init`` (its seconds and the card's peak), two
    requests of 2 synthetic 336x336 videos, 64 new tokens each: launch
    counts per request as the code implies (an unfused int8 layer runs seven
    weight products a step), EventPredictions, the head slices; the int8
    configuration once more with the dequant body of row 3b; check (e) on a
    request of 8 tokens (every kernel held to its plain version on the
    path's own inputs); and the prefix and first-token logits of the kernel
    path no further from an fp32 model of the same weights than the plain
    path, within REF_RATIO_TOL. The open_llama_3b-shaped decoder (hd 100)
    and the Falcon3-shaped one (hd 256) run their int8 dequant request under
    check (e) too; the second's bf16 tree prefills a chunk with marked
    cache slots (two launches of row 8 a layer, ``chunked_prefill_check``);
    then one ``lora`` step of each (``hd_lora_step``: rows 8-10 at hd 100
    and 256 under check (e)). Returns the launches of the G = 7 rows
    (``*_g7``, the counts of rows 3 and 3b on the qwen2 path, whose every
    decode attention is at G = 7), of the hd-100 rows (``*_hd100``, on the
    open_llama_3b path) and of the hd-256 rows (``*_hd256``, on the Falcon3
    path) and the stats."""
    import gc
    import shutil

    import numpy as np

    from trace_tpu_torch import EventPredictions
    from trace_tpu_torch.checkpoint.convert import trace_config_from_hf
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.model.config import DecoderConfig, TraceConfig
    from trace_tpu_torch.runtime import pipeline as pl
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    t_phase = time.perf_counter()
    manifest = json.loads((Path(__file__).resolve().parent / CKPT_MANIFEST).read_text())
    vision_keys = [(k, tuple(v)) for k, v in manifest["keys"].items()
                   if k.startswith("model.vision_tower.")]
    tok = SpmLikeTokenizer()
    cut = lambda d: dataclasses.replace(d, num_layers=FAMILY_LAYERS)
    families = {
        "qwen2": ("qwen2", TraceConfig(decoder=cut(DecoderConfig.qwen2_7b()))),
        "vicuna": ("llama", TraceConfig(decoder=cut(DecoderConfig.vicuna_7b()),
                                        mm_projector_type="stc_connector_v35",
                                        num_slots=VICUNA_SLOTS, num_frames=VICUNA_FRAMES)),
        "openllama": ("llama", TraceConfig(decoder=cut(
            trace_config_from_hf(OPEN_LLAMA_3B).decoder))),
        "falcon3": ("llama", TraceConfig(decoder=cut(trace_config_from_hf(FALCON3_7B).decoder))),
    }
    asks = ["Localize the visual events in the video and describe each one.",
            "Find every moment where something changes, with timestamps."]
    launches, stats = {}, {}
    for family, (model_type, cfg) in families.items():
        ckpt = tmp / f"{family}-7b"
        t0 = time.perf_counter()
        nbytes = write_checkpoint(torch, ckpt, family_keys(cfg, vision_keys), cfg, model_type)
        print(f"families: {family} checkpoint ({model_type}, {cfg.decoder.num_layers} layers, "
              f"{cfg.mm_projector_type}), {nbytes / 1e9:.2f} GB of bf16 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        T = cfg.num_frames
        rng = np.random.default_rng(SEED)
        videos = [rng.integers(0, 256, (T, 336, 336, 3), dtype=np.uint8) for _ in range(VIDEOS)]
        stamps = [[[float(i)] for i in range(T)]] * VIDEOS
        for mode in (m for m in FAMILY_MODES if m.startswith(family)):
            quant = mode.split()[1]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = pl.model_init(str(ckpt), quant=quant, tokenizer=tok)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            pc, dec = pipe.config, pipe.config.decoder
            if (dec != dataclasses.replace(cfg.decoder, kv_cache_dtype=dec.kv_cache_dtype,
                                           act_quant=dec.act_quant)
                    or pc.mm_projector_type != cfg.mm_projector_type
                    or pc.num_slots != cfg.num_slots or pc.num_frames != T):
                fail(f"{mode}: model_init gave {pc}, not the checkpoint's config {cfg}")
            layers = pipe._decoder_params["layers"]
            fused = "wqkv" in layers
            if dec.attn_qkv_bias and (fused or "bq" not in layers):
                fail(f"{mode}: the biased tree is fused or lost its biases")
            L, steps_all = dec.num_layers, []
            vit_layers = pc.vision.num_layers + 1 + pc.vision.select_layer
            chunks = VIDEOS * T // pc.vit_chunk_size
            for request in (1, 2):
                reset_serving_launches()
                t0 = time.perf_counter()
                preds = pipe.infer_events_batch(videos, stamps, asks, max_new_tokens=MAX_NEW)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got, s = serving_launches(), pipe.last_stats
                steps = s["decode_steps"]
                want = dict.fromkeys(got, 0)
                want.update({"vit_attention_btd": vit_layers * chunks, "flash_attention": L})
                if quant == "int8":
                    want.update({"decode_attention_int8_s8dot": L * steps, "quant_matmul": steps + 1,
                                 "quant_matmul_stacked": (4 if fused else 7) * L * steps})
                else:
                    want["decode_attention"] = L * steps
                print(f"families: {mode} request {request}: launches {got} expected {want}; "
                      f"{s['prefix_tokens']} prefix tokens, {steps} decode steps; wall "
                      f"{wall:.3f} s, encode {s['encode_s']:.3f} s, prefill {s['prefill_s']:.3f} "
                      f"s, decode {1e3 * s['decode_s'] / max(steps, 1):.2f} ms/step", flush=True)
                if got != want or steps <= 0:
                    fail(f"{mode}: launch counts {got} != expected {want}")
                if not all(isinstance(p, EventPredictions) for p in preds):
                    fail(f"{mode}: output does not parse into EventPredictions")
                check_head_slices(dec, s["tokens"])
                steps_all.append(1e3 * s["decode_s"] / max(steps, 1))
            counts, tokens = got, pipe.last_stats["tokens"]
            held_dequant = {}
            if quant == "int8" and dec.head_dim != 128:  # check (e) of the dequant body too
                dequant, held_dequant = on_path(torch, f"{mode} dequant", lambda: dequant_request(
                    torch, serving_tree(pipe), pc, tok, videos, stamps, asks))
                counts.update(dequant)
            elif quant == "int8":
                counts.update(dequant_request(torch, serving_tree(pipe), pc, tok, videos,
                                              stamps, asks))
            for row, name in FAMILY_ROWS.get(mode, {}).items():
                launches[name] = counts[row]
            _, held = on_path(torch, mode, lambda: pipe.infer_events_batch(
                videos, stamps, asks, max_new_tokens=8))
            held.update(held_dequant)
            check = reference_check(torch, pipe, serving_tree(pipe), pc, tok, videos, stamps,
                                    asks, mode, tokens, profile=False)
            if mode == "falcon3 bf16":  # row 8 at hd 256: a chunk with marked cache slots
                n = fb.flash_attention_fwd_res.launches
                check["chunked_prefill"] = chunked_prefill_check(torch, pipe, mode,
                                                                 CHUNK_TOL_BF16)
                launches["flash_attention_fwd_res_hd256"] = fb.flash_attention_fwd_res.launches - n
            stats[mode] = {"model_init_s": init_s, "ms_per_step": steps_all,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "launches": counts, "on_path": held, "reference": check,
                           "fused": fused}
            print(f"families: {mode}: model_init {init_s:.1f} s, decode "
                  f"{' / '.join(f'{t:.2f}' for t in steps_all)} ms/step (requests 1 / 2), "
                  f"peak {stats[mode]['peak_gib']:.2f} GiB on the card", flush=True)
            del pipe, layers
        shutil.rmtree(ckpt)
    for family in ("openllama", "falcon3"):
        lora_launches, stats[f"{family} lora"] = hd_lora_step(torch, family,
                                                              families[family][1], tmp)
        for name, n in lora_launches.items():  # row 8 at hd 256: the chunk's count
            launches.setdefault(name, n)
    idle = [name for name, n in launches.items() if n <= 0]
    if idle or len(launches) != 17:
        fail(f"families: rows at G = 7, hd 100 or hd 256 not launched: "
             f"{idle or sorted(launches)}")
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"families: phase 9 took {stats['seconds']:.1f} s; launches of the G = 7, hd-100 "
          f"and hd-256 rows {launches}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def hd_lora_step(torch, family: str, base, tmp: Path) -> tuple:
    """One ``lora`` step of ``train_loop`` on phase 9's ``family`` model
    (``base``: the open_llama_3b-shaped one at hd 100, the Falcon3-shaped one
    at hd 256) at HD_LORA_LAYERS layers: random weights from SEED, rank-128
    adapters on the seven decoder projections, phase 6's synthetic videos at
    batch VIDEOS. Rows 8, 9 and 10 at the model's hd, with check (e) on the
    step's own inputs: the first call of row 8 (the forward with its
    residuals, o and lse) at each shape and of rows 9-10 (``watch_backward``)
    against their plain versions; no plain version on the card; a finite loss
    and a finite, non-zero gradient norm (the schedule starts at 0, so the
    step moves no adapter). Returns ({``*_hd<hd>``: launches}, stats)."""
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.train.train import TrainRecipe, train_loop, tree_paths

    params, cfg = train_params(torch, "lora", HD_LORA_LAYERS, base=base)
    layers, hd = cfg.decoder.num_layers, cfg.decoder.head_dim
    sfx = f"_hd{hd}"
    data = SyntheticVideos(cfg, SpmLikeTokenizer(), VIDEOS)
    adapters = [p for p, _ in tree_paths(params) if "_lora_" in p]
    fns = {"flash_attention_fwd_res": fb.flash_attention_fwd_res,
           "flash_attention_bwd_dq": fb.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": fb.flash_attention_bwd_dkv}
    for fn in fns.values():
        fn.launches = 0
    # row 8's launch: flash_attention_fwd_res's kernel route (``_forward``
    # with the residual), watched where it calls it, so that the wrapper and
    # its launch count stay as they are
    orig, fwd_held = fb._forward, {}

    def fwd_watched(q, k, v, mask_bias, *, causal, q_offset, lse=False):
        out = orig(q, k, v, mask_bias, causal=causal, q_offset=q_offset, lse=lse)
        shapes = f"q {list(q.shape)}, k {list(k.shape)}"
        if lse and shapes not in fwd_held:
            ref = fb.flash_attention_fwd_res_plain(q, k, v, mask_bias, causal=causal,
                                                   q_offset=q_offset)
            r = compare("flash_attention_fwd_res" + sfx, out[0], ref[0])
            r["lse_err"] = (out[1] - ref[1]).abs().max().item()
            fwd_held[shapes] = r
        return out

    # a schedule of two steps (one is all warmup), one batch: one step runs
    recipe = TrainRecipe(stage="lora", learning_rate=1e-4, total_steps=2)
    log = tmp / f"train_lora{sfx}.jsonl"
    plain, undo = watch_plain(torch)
    held, undo_held = watch_backward(torch)
    fb._forward = fwd_watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        train_loop(params, cfg, data.resized(VIDEOS), recipe, batch_size=VIDEOS,
                   log_every=1, metrics_path=str(log))
        torch.cuda.synchronize()
    finally:
        fb._forward = orig
        undo_held()
        undo()
    wall = time.perf_counter() - t0
    bad = []
    checks = {("flash_attention_fwd_res" + sfx, shapes): r for shapes, r in fwd_held.items()}
    checks.update({(name + sfx, shapes): r for (name, shapes), r in held.items()})
    for (name, shapes), r in checks.items():
        atol, rtol = KERNEL_TOL[name]
        lse = f", lse max_abs_err={r['lse_err']:.2e} (<= {LSE_TOL})" if "lse_err" in r else ""
        print(f"families: {family} lora check (e): {name} on [{shapes}]: max_abs_err="
              f"{r['err']:.6g} excess={r['excess']:.3g} (|diff| <= {atol} + {rtol} |ref|) "
              f"rel_norm_err={r['rel_norm']:.3g} (<= {REL_NORM_TOL}){lse}", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL
                and r.get("lse_err", 0.0) <= LSE_TOL):
            bad.append(f"{name} on [{shapes}]")
    if {name for name, _ in checks} != {n + sfx for n in fns} or bad:
        fail(f"families: {family} lora (e): rows 8-10 not held at hd {hd}, or kernel and "
             f"plain version disagree: {bad or sorted(checks)}")
    records = [json.loads(line) for line in log.read_text().splitlines()]
    got = {name + sfx: fn.launches for name, fn in fns.items()}
    want = {"flash_attention_fwd_res" + sfx: 2 * layers, "flash_attention_bwd_dq" + sfx: layers,
            "flash_attention_bwd_dkv" + sfx: layers}
    ran_plain = {k: v for k, v in plain.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = records[-1]["loss"] if records else float("nan")
    print(f"families: {family} lora step ({layers} layers, hd {hd}): {wall:.2f} s/step (one "
          f"step, its check (e) inside), loss "
          f"{loss:.5f}, grad norm {records[-1]['grad_norm'] if records else None}, peak "
          f"{peak:.2f} GiB; launches {got} expected {want}; plain versions on the card "
          f"{ran_plain or 'none'}", flush=True)
    if (got != want or ran_plain or len(records) != 1 or not math.isfinite(loss)
            or not 0 < records[-1]["grad_norm"] < math.inf or not adapters):
        fail(f"families: {family} lora step: launches, plain versions or loss not as expected")
    del params, adapters
    torch.cuda.empty_cache()
    return got, {"layers": layers, "head_dim": hd, "wall_s": wall, "peak_gib": peak,
                 "loss": loss, "grad_norm": records[-1]["grad_norm"], "launches": got,
                 "on_path": {f"{n} [{sh}]": r for (n, sh), r in checks.items()}}


# Phase 10: Mixtral-8x7B, the routed-expert decoder, at the published widths
# of mistralai/Mixtral-8x7B-v0.1's config.json (D 4096, I 14336, 32 / 8
# heads, hd 128, vocab 32000, rope_theta 1e6, rms_norm_eps 1e-5, 8 local
# experts, 2 a token) at a depth of MOE_LAYERS of its 32 layers: 32 layers are
# ~93 GB in bf16 and do not fit one 80 GB card, and 4 (11.3 GB of experts)
# kept the written checkpoint near phase 9's; 2 since the whole smoke took
# 1004 s with PR 20's fp32 checks (my chip call 7, PR 20). CLIP ViT-L/14-336
# and spatial_slot at 128 frames, random bf16 values, written by phase 7's
# writer in HF Mixtral key names and loaded through ``model_init``.
MOE_LAYERS = 2
MOE_TRAIN_TOKENS = 2048  # the lora steps' row: one video, batch 1
MOE_LORA_TARGETS = ("wq", "wk", "wv", "wo")  # a routed layer takes no MLP adapter


def moe_phase(torch, tmp: Path) -> tuple:
    """Phase 10: (a) the checkpoint written, ``model_init`` bf16 (the dense
    mixture, as converted checkpoints get), two requests of 2 synthetic
    336x336 128-frame videos with 64 new tokens (launch counts of rows 1, 2
    and 3, EventPredictions, head slices), ``infer_events`` on an ``.npy``
    of one of them, check (e) on a request of 8 tokens, and the prefix and
    first-token logits no further from an fp32 model than the plain path
    (REF_RATIO_TOL), with the routing flips of each layer reported; (b) the
    same tree in the sparse form (capacity factor 2.0) with the int8 KV
    cache through ``TracePipeline``: row 3b on the path, held the same way;
    (c) ``model_init(quant="int8")`` raises the ValueError that names
    Mixtral; (d) two ``lora`` train steps (adapters on the attention
    projections) at batch 1 x MOE_TRAIN_TOKENS with 128 frames: a first
    forward + backward whose adapters all take finite, non-zero gradients,
    then the steps, losses finite, every adapter moved by the second (the
    schedule starts at 0), rows 8-10 launched. Returns the launches of
    the path's rows and the stats."""
    import gc
    import shutil

    import numpy as np

    from trace_tpu_torch import EventPredictions, infer_events
    from trace_tpu_torch.checkpoint.loader import load_pretrained
    from trace_tpu_torch.model.config import MoEConfig, TraceConfig
    from trace_tpu_torch.model.lora import add_lora_params
    from trace_tpu_torch.model.trace_model import forward_train
    from trace_tpu_torch.runtime import pipeline as pl
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.train.train import (
        TrainRecipe,
        _batch_to_device,
        _to_device,
        build_optimizer,
        make_train_step,
        param_group,
        preprocess_batch_frames,
        tree_paths,
    )

    t_phase = time.perf_counter()
    manifest = json.loads((Path(__file__).resolve().parent / CKPT_MANIFEST).read_text())
    vision_keys = [(k, tuple(v)) for k, v in manifest["keys"].items()
                   if k.startswith("model.vision_tower.")]
    cfg = TraceConfig(decoder=dataclasses.replace(
        MoEConfig.mixtral_8x7b(), rope_theta=1000000.0, num_layers=MOE_LAYERS))
    dec0 = cfg.decoder
    ckpt = tmp / "mixtral-8x7b"
    t0 = time.perf_counter()
    nbytes = write_checkpoint(torch, ckpt, family_keys(cfg, vision_keys), cfg, "mixtral")
    print(f"moe: Mixtral-8x7B checkpoint (mixtral, {MOE_LAYERS} of 32 layers: depth cut to "
          f"fit one card; D {dec0.hidden_size}, I {dec0.intermediate_size}, "
          f"{dec0.num_experts} experts, top {dec0.top_k}, vocab {dec0.vocab_size}, rope_theta "
          f"{dec0.rope_theta:g}), {nbytes / 1e9:.2f} GB of bf16 written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tok = SpmLikeTokenizer()
    rng = np.random.default_rng(SEED)
    videos = [rng.integers(0, 256, (FRAMES, 336, 336, 3), dtype=np.uint8) for _ in range(VIDEOS)]
    stamps = [[[float(i)] for i in range(FRAMES)]] * VIDEOS
    asks = ["Localize the visual events in the video and describe each one.",
            "Find every moment where something changes, with timestamps."]
    stats, launches = {}, {}

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = pl.model_init(str(ckpt), quant="bf16", tokenizer=tok)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pc = pipe.config
    if (pc.decoder != dataclasses.replace(dec0, moe_impl="dense")
            or pc.mm_projector_type != cfg.mm_projector_type or pc.num_frames != FRAMES):
        fail(f"moe: model_init gave {pc}, not the checkpoint's config {cfg}")
    layers = pipe._decoder_params["layers"]
    if layers["w_gate"].shape != (MOE_LAYERS, 8, 4096, 14336) or "router" not in layers:
        fail(f"moe: the decoder's expert stacks are {tuple(layers['w_gate'].shape)}")
    print(f"moe: model_init bf16 {init_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card", flush=True)
    tree = serving_tree(pipe)
    L = MOE_LAYERS
    vit_layers = pc.vision.num_layers + 1 + pc.vision.select_layer
    chunks = VIDEOS * FRAMES // pc.vit_chunk_size

    def serve(mode, p, row):
        """Two requests: launches, the phase times, the head slices; check (e)
        on an 8-token request; the fp32 reference check."""
        steps_all, reqs = [], []
        for request in (1, 2):
            reset_serving_launches()
            t0 = time.perf_counter()
            preds = p.infer_events_batch(videos, stamps, asks, max_new_tokens=MAX_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, s = serving_launches(), p.last_stats
            steps = s["decode_steps"]
            want = dict.fromkeys(got, 0)
            want.update({"vit_attention_btd": vit_layers * chunks, "flash_attention": L,
                         row: L * steps})
            print(f"moe: {mode} request {request}: launches {got} expected {want}; "
                  f"{s['prefix_tokens']} prefix tokens, {steps} decode steps; wall {wall:.3f} "
                  f"s, encode {s['encode_s']:.3f} s, prefill {s['prefill_s']:.3f} s, decode "
                  f"{1e3 * s['decode_s'] / max(steps, 1):.2f} ms/step", flush=True)
            if got != want or steps <= 0:
                fail(f"moe {mode}: launch counts {got} != expected {want}")
            if not all(isinstance(x, EventPredictions) for x in preds):
                fail(f"moe {mode}: output does not parse into EventPredictions")
            check_head_slices(p.config.decoder, s["tokens"])
            steps_all.append(1e3 * s["decode_s"] / max(steps, 1))
            reqs.append({k: v for k, v in s.items() if k != "tokens"} | {"wall_s": wall})
        counts, tokens = got, p.last_stats["tokens"]
        _, held = on_path(torch, f"moe {mode}", lambda: p.infer_events_batch(
            videos, stamps, asks, max_new_tokens=8))
        check = reference_check(torch, p, serving_tree(p), p.config, tok, videos, stamps,
                                asks, f"moe {mode}", tokens, profile=False)
        return counts, {"ms_per_step": steps_all, "requests": reqs, "launches": counts,
                        "on_path": held, "reference": check}

    # (a) the dense mixture from the checkpoint, bf16 KV cache
    counts, stats["bf16 dense"] = serve("bf16 dense", pipe, "decode_attention")
    launches.update({k: v for k, v in counts.items() if v})
    video_path = tmp / "moe_video.npy"
    np.save(video_path, videos[0])
    t0 = time.perf_counter()
    pred = infer_events(pipe, str(video_path), asks[0], max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    stats["bf16 dense"]["infer_events_s"] = time.perf_counter() - t0
    if not isinstance(pred, EventPredictions):
        fail("moe: infer_events on an .npy did not give EventPredictions")
    print(f"moe: infer_events on an .npy of {FRAMES} frames: "
          f"{stats['bf16 dense']['infer_events_s']:.3f} s", flush=True)

    # (b) the same weights in the sparse form with the int8 KV cache. Its pad
    # rows take bucket slots before the real tokens, so which real
    # assignments overflow follows what the pad rows hold: the attention
    # kernel gives a row that sees no key the plain version's mean of v
    sparse_cfg = dataclasses.replace(pc, decoder=dataclasses.replace(
        pc.decoder, moe_impl="sparse", capacity_factor=2.0, kv_cache_dtype="int8"))
    sparse = pl.TracePipeline(tree, sparse_cfg, tok)
    counts, stats["sparse int8-kv"] = serve("sparse int8-kv", sparse,
                                            "decode_attention_int8_s8dot")
    launches.update({k: v for k, v in counts.items() if v})
    serving_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del sparse, tree, pipe, layers
    gc.collect()
    torch.cuda.empty_cache()

    # (c) no quantized Mixtral
    try:
        pl.model_init(str(ckpt), quant="int8", tokenizer=tok)
    except ValueError as e:
        if "Mixtral" not in str(e):
            fail(f"moe: model_init(quant='int8') raised another ValueError: {e}")
        print(f"moe: model_init(quant='int8') raises ValueError: {e}", flush=True)
    else:
        fail("moe: model_init(quant='int8') on a Mixtral checkpoint did not raise")

    # (d) two lora steps at batch 1 x MOE_TRAIN_TOKENS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, tcfg = load_pretrained(str(ckpt))
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(
        tcfg.decoder, lora_r=128, lora_alpha=256.0))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = _to_device(params, torch.device("cuda"))
    params["decoder"] = add_lora_params(params["decoder"], tcfg.decoder, gen,
                                        targets=MOE_LORA_TARGETS)
    for name, leaf in params["decoder"]["layers"].items():
        if name.endswith("_lora_b"):  # B = 0 would hold A's gradients at zero
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda") * 1e-3)
    load_s = time.perf_counter() - t0
    data = SyntheticVideos(tcfg, tok, 1)
    if data.max_len != MOE_TRAIN_TOKENS:
        fail(f"moe: the training row is {data.max_len} tokens, not {MOE_TRAIN_TOKENS}")
    from trace_tpu_torch.data.dataset import collate_batch

    batch = collate_batch([data[0]])
    dev_batch = _batch_to_device(batch, torch.device("cuda"))
    dev_batch["frames"] = preprocess_batch_frames(dev_batch.pop("frames_u8"), tcfg)
    adapters = []
    for path, x in tree_paths(params):
        x.requires_grad_(param_group(path, "lora") != "frozen" and not path.startswith("vision"))
        x.grad = None
        if "_lora_" in path:
            adapters.append((path, x))
    loss, _ = forward_train(params, tcfg, dev_batch)
    loss.backward()
    dead = [p for p, x in adapters
            if x.grad is None or not torch.isfinite(x.grad).all() or x.grad.abs().max() == 0]
    for _, x in tree_paths(params):
        x.grad = None
    print(f"moe: lora forward + backward: loss {loss.item():.5f}, "
          f"{len(adapters) - len(dead)} of {len(adapters)} adapter leaves with finite, "
          f"non-zero gradients", flush=True)
    if not math.isfinite(loss.item()) or dead or not adapters:
        fail(f"moe lora: loss {loss.item()}, adapters without gradients {dead}")
    del loss
    recipe = TrainRecipe(stage="lora", learning_rate=1e-4, total_steps=TRAIN_STEPS)
    tx = build_optimizer(params, recipe)
    opt = tx.init(params)
    step_fn = make_train_step(tcfg, tx, freeze_stage="lora")
    for fn in train_counts().values():
        fn.launches = 0
    before = {p: x.detach().clone() for p, x in adapters}
    losses, step_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train_launches = {name: fn.launches for name, fn in train_counts().items()}
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"moe: lora steps at batch 1 x {data.max_len} tokens ({data.real[0]} real), "
          f"{MOE_LAYERS} layers: losses {losses}, {' / '.join(f'{t:.3f}' for t in step_s)} "
          f"s/step, launches {train_launches}, peak {train_peak:.2f} GiB (load + adapters "
          f"{load_s:.1f} s)", flush=True)
    # the schedule starts at 0: the first step moves nothing, the second every adapter
    still = [p for p, x in adapters if torch.equal(x.detach(), before[p])]
    if not all(math.isfinite(x) for x in losses) or still:
        fail(f"moe lora: losses {losses}, adapters that did not move {still}")
    want_rows = {"flash_attention_fwd_res": 2 * 2 * L, "flash_attention_bwd_dq": 2 * L,
                 "flash_attention_bwd_dkv": 2 * L}
    if any(train_launches[k] != n for k, n in want_rows.items()):
        fail(f"moe lora: launches {train_launches}, expected {want_rows} of rows 8-10")
    for name, n in train_launches.items():
        launches.setdefault(name, n)
    stats["lora"] = {"losses": losses, "s_per_step": step_s, "peak_gib": train_peak,
                     "launches": train_launches, "load_s": load_s}
    del params, opt, tx, step_fn, dev_batch
    shutil.rmtree(ckpt)
    stats.update(model_init_s=init_s, serving_peak_gib=serving_peak,
                 seconds=time.perf_counter() - t_phase)
    print(f"moe: phase 10 took {stats['seconds']:.1f} s; serving peak {serving_peak:.2f} GiB, "
          f"lora peak {train_peak:.2f} GiB; launches on the Mixtral path {launches}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


PAR_RANKS = 2            # ranks of phase 11, all on the one card
# depth of the tensor-parallel bf16 / int8 requests: cut from 32 when my chip
# call 4 (PR 20) ran the whole smoke in 1033 s, then from 16 when call 6 took
# 1048 s; their one-rank and fp32 references are built at this depth
# (first_token_refs)
PAR_SERVE_LAYERS = 8
PP_LAYERS = 8            # depth of the pipeline check
PP_MICRO = 2             # its microbatches
PP_TOKENS = 2048         # its rows' length
PAR_TRAIN_LAYERS = 4     # depth of the tensor-parallel lora steps
# their number: the schedule's first step has learning rate 0, so the later
# ones check the sharded update and run on adapters it moved
PAR_TRAIN_STEPS = 3
PAR_TIMEOUT_S = 900      # the ranks' deadline
# relative limits (||diff|| / ||ref||) of phase 11's comparisons with the
# one-rank path on the same bf16 inputs. The expert-parallel sum adds the
# ranks' fp32 partial sums in another order before the bf16 cast (~1e-3 of a
# bf16 step); the pipeline runs the same kernels on microbatches of one row
# (the products' tiles, and so their fp32 sums, may differ): a few bf16
# steps through 8 layers; a dropped expert, microbatch or stage moves them
# by far more than these.
EP_REL_TOL = 1e-2
PP_REL_TOL = 3e-2
# the tensor-parallel lora steps' losses and grad norms against the one-rank
# run's (|diff| / |one rank's|): partial products summed in fp32 where one
# rank rounds each product to bf16. A card run at 4 layers, model 2, read
# 2.1e-4 for the losses and 6.9e-4 for the grad norms; the limits are about
# 5x and 4x those
PAR_LOSS_RTOL = 1e-3
PAR_NORM_RTOL = 3e-3


def kernel_counts() -> dict:
    """Every kernel wrapper's launches so far, under the rows' names."""
    return {**serving_launches(),
            **{name: fn.launches for name, fn in train_counts().items()
               if name not in ("flash_attention", "vit_attention_btd")}}


def count_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in kernel_counts().items()
            if v - before.get(k, 0)}


def first_logits(torch, pipe, prefix, mask, impl: str):
    """The first-token logits of ``pipe``'s decoder from a prefill of the
    prefix left-padded to a multiple of 128, as the pipeline pads it."""
    from trace_tpu_torch.model.mistral import compute_logits
    from trace_tpu_torch.runtime import generate as gen

    P = prefix.shape[1]
    bucket = -(-P // 128) * 128
    pe = torch.nn.functional.pad(prefix, (0, 0, bucket - P, 0))
    pm = torch.nn.functional.pad(mask, (bucket - P, 0))
    state = gen.prefill(pipe._decoder_params, pipe.config.decoder, pe, pm,
                        cache_len=bucket + 1, impl=impl)
    return compute_logits(pipe._decoder_params, state[2], impl=impl)


def first_token_refs(torch, mode: str) -> dict:
    """Phase 11's references for ``mode`` at PAR_SERVE_LAYERS layers: the
    one-rank kernel path's and the fp32 model's first-token logits on phase
    4's requests, built one at a time (what reference_check leaves in STASH
    for phase 4's 32-layer model)."""
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    tok = SpmLikeTokenizer()
    params, cfg = serving_model(torch, mode, layers=PAR_SERVE_LAYERS)
    pipe = TracePipeline(params, cfg, tok)
    del params
    videos, stamps, asks = request_inputs()
    prefix, mask = pipe.encode_prefix(videos, stamps, asks)
    kernel = first_logits(torch, pipe, prefix, mask, "auto")
    del prefix
    fcfg = dataclasses.replace(
        cfg, dtype=torch.float32,
        decoder=dataclasses.replace(cfg.decoder, kv_cache_dtype="bf16", act_quant=False),
        vision=dataclasses.replace(cfg.vision, act_quant=False))
    ref_params = dequantized_fp32(pipe.params)
    ref_params["decoder"]["embed"] = pipe._combined[:cfg.decoder.vocab_size].float()
    del pipe
    torch.cuda.empty_cache()
    ref = TracePipeline(ref_params, fcfg, tok, attn_impl="plain")
    del ref_params
    prefix, mask = ref.encode_prefix(videos, stamps, asks)
    fp32 = first_logits(torch, ref, prefix, mask, "plain")
    del ref, prefix
    torch.cuda.empty_cache()
    return {"fp32_logits": fp32.cpu(), "kernel_logits": kernel.cpu(),
            "kernel_vs_fp32": rel_err(kernel, fp32)}


def _tp_serving(torch, mesh, mode: str, rank: int) -> dict:
    """Two requests of phase 4's videos through shard_params_for_inference,
    encode_prefix_sharded and generate_sharded on this rank: check (e) on
    the first, the collectives' share of its decode loop, launch counts per
    request, the second's first-token logits."""
    import numpy as np

    from trace_tpu_torch.parallel import collectives
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.mesh import shard_params_for_inference
    from trace_tpu_torch.runtime.pipeline import TracePipeline, encode_prefix_sharded
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    t0 = time.perf_counter()
    params, cfg = serving_model(torch, mode, layers=PAR_SERVE_LAYERS)
    tok = SpmLikeTokenizer()
    pipe = TracePipeline(params, cfg, tok)
    del params
    pipe._prepare_memory_layout()  # the combined table, the fused ViT, the serving layout
    dec = shard_params_for_inference(pipe._decoder_params, mesh)
    pipe._decoder_params = pipe.params = None
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    videos, stamps, asks = request_inputs()
    L, vit_layers = cfg.decoder.num_layers, cfg.vision.num_layers + 1 + cfg.vision.select_layer
    requests, logits, check_e, share = [], None, None, None

    def request():
        t0 = time.perf_counter()
        per_sample = [pipe._prepare_sample_host(f, ts, q) for f, ts, q in zip(videos, stamps, asks)]
        token_ids, video_pos, mask = pipe._prompt_layout(per_sample)
        frames = torch.stack([pipe._resolve_frames(s[2]) for s in per_sample])
        fids = np.stack([s[3] for s in per_sample])
        prefix = encode_prefix_sharded(
            pipe._encode_params, cfg, pipe._upload(token_ids), torch.from_numpy(video_pos),
            frames, pipe._upload(fids), pipe._combined, mesh)
        del frames
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        out = gen.generate_sharded(dec, cfg.decoder, prefix, pipe._upload(mask), pipe._combined,
                                   mesh=mesh, max_new_tokens=MAX_NEW, initial_head=1,
                                   eos_id=tok.eos_token_id)
        return out, encode_s

    compute_logits, decode = gen.compute_logits, gen.decode
    for r in (1, 2):
        seen = []

        def first(*a, **k):  # the first-token logits of the request
            out = compute_logits(*a, **k)
            if not seen:
                seen.append(out.detach().cpu())
            return out

        def timed_decode(*a, **k):  # the collectives' time in the decode loop
            collectives.TIMING.update(on=r == 1, seconds=0.0, calls=0)
            try:
                return decode(*a, **k)
            finally:
                collectives.TIMING["on"] = False

        gen.compute_logits, gen.decode = first, timed_decode
        before = kernel_counts()
        try:
            if r == 1:
                (out, encode_s), check_e = on_path(
                    torch, f"parallel {mode}, rank {rank}", request)
            else:
                out, encode_s = request()
        finally:
            gen.compute_logits, gen.decode = compute_logits, decode
        got = count_delta(before)
        steps = out.decode_steps
        want = {"vit_attention_btd": vit_layers, "flash_attention": L}
        if mode == "int8":
            want.update({"decode_attention_int8_s8dot": L * steps,
                         "quant_matmul_stacked": 7 * L * steps, "quant_matmul": steps + 1})
        else:
            want["decode_attention"] = L * steps
        t = out.phase_times
        rec = {"encode_s": encode_s, "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
               "decode_steps": steps, "launches": got, "tokens": out.tokens.tolist()}
        if r == 1:
            share = {"collective_s": collectives.TIMING["seconds"],
                     "collective_calls": collectives.TIMING["calls"],
                     "share_of_decode": collectives.TIMING["seconds"] / max(t["decode_s"], 1e-9)}
            print(f"parallel rank {rank}, {mode}: gloo collectives take "
                  f"{100 * share['share_of_decode']:.1f} % of request 1's decode loop "
                  f"({share['collective_calls']} calls, {share['collective_s']:.3f} s of "
                  f"{t['decode_s']:.3f} s)", flush=True)
        print(f"parallel rank {rank}, {mode} request {r}: launches {got} expected {want}; "
              f"encode {encode_s:.3f} s, prefill {t['prefill_s']:.3f} s, decode "
              f"{1e3 * t['decode_s'] / max(steps, 1):.2f} ms/step over {steps} steps", flush=True)
        if got != want or steps <= 0:
            fail(f"parallel {mode}, rank {rank}: launch counts {got} != expected {want}")
        check_head_slices(cfg.decoder, out.tokens)
        requests.append(rec)
        logits = seen[0]
    del dec, pipe
    torch.cuda.empty_cache()
    return {"init_s": init_s, "requests": requests, "first_logits": logits,
            "collectives": share, "check_e": check_e}


# the quant="int4" tensor-parallel request: its depth, and the limit of its
# first-token logits' distance from one rank's on the same prefix (the
# row-parallel products sum their partial sums in fp32 across the ranks
# before the bf16 cast, one rank in one sum: a bf16 step here and there,
# which random weights amplify over the layers)
TP_INT4_LAYERS = 8
TP_INT4_TOL = 5e-2
TP_INT4_ROWS = {"flash_attention", "decode_attention_int8_s8dot", "quant_matmul_p4",
                "quant_matmul_p4_mma", "quant_matmul"}


def _tp_int4(torch, mesh, rank: int) -> dict:
    """One request of phase 4's videos in the native int4 serving
    configuration (``int4_serving``: per-channel packed, weight-only, int8 KV
    cache) at TP_INT4_LAYERS layers: the prefix encoded on this rank, then
    ``generate`` on the whole tree and ``generate_sharded`` on the rank's
    shards (``shard_params_for_inference`` packs them on the rank), check (e)
    at the local shapes; the rows launched, the first-token logits of both
    and their greedy tokens."""
    from trace_tpu_torch.model.quantize import int4_serving
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.mesh import shard_params_for_inference
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    params, cfg = int4_serving(*serving_model(torch, "bf16", layers=TP_INT4_LAYERS))
    tok = SpmLikeTokenizer()
    pipe = TracePipeline(params, cfg, tok)
    del params
    videos, stamps, asks = request_inputs()
    prefix, mask = pipe.encode_prefix(videos, stamps, asks)
    kw = dict(max_new_tokens=MAX_NEW, initial_head=1, eos_id=tok.eos_token_id)
    seen, compute_logits = [], gen.compute_logits

    def first(*a, **k):
        out = compute_logits(*a, **k)
        if not seen:
            seen.append(out.detach().cpu())
        return out

    gen.compute_logits = first
    try:
        one = gen.generate(pipe._decoder_params, cfg.decoder, prefix, mask, pipe._combined, **kw)
        one_logits = seen.pop()
        dec = shard_params_for_inference(pipe._decoder_params, mesh)
        shapes = {n: list(leaf["qp"].shape) for n, leaf in dec["layers"].items()
                  if isinstance(leaf, dict) and "qp" in leaf}
        before = kernel_counts()
        t0 = time.perf_counter()
        out, check_e = on_path(torch, f"parallel int4, rank {rank}", lambda: gen.generate_sharded(
            dec, cfg.decoder, prefix, mask, pipe._combined, mesh=mesh, **kw))
        wall = time.perf_counter() - t0
        tp_logits = seen.pop()
    finally:
        gen.compute_logits = compute_logits
    got = count_delta(before)
    del dec, pipe, prefix
    torch.cuda.empty_cache()
    t = out.phase_times
    rec = {"wall_s": wall, "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
           "decode_steps": out.decode_steps, "launches": got, "shapes": shapes,
           "tokens": out.tokens.tolist(), "one_rank_tokens": one.tokens.tolist(),
           "logits_vs_one_rank": rel_err(tp_logits, one_logits),
           "finite": bool(torch.isfinite(tp_logits).all()), "check_e": check_e}
    print(f"parallel rank {rank}, int4 ({TP_INT4_LAYERS} layers): launches {got}; local packed "
          f"shapes {shapes}; prefill {t['prefill_s']:.3f} s, decode "
          f"{1e3 * t['decode_s'] / max(out.decode_steps, 1):.2f} ms/step over "
          f"{out.decode_steps} steps; first-token logits from one rank's "
          f"{rec['logits_vs_one_rank']:.3g}", flush=True)
    if set(got) != TP_INT4_ROWS:
        fail(f"parallel int4, rank {rank}: rows launched {sorted(got)}, expected "
             f"{sorted(TP_INT4_ROWS)}")
    check_head_slices(cfg.decoder, out.tokens)
    return rec


def _ep_check(torch, mesh, rank: int, hidden) -> dict:
    """One Mixtral-8x7B layer at its published widths, E / ranks experts a
    rank, on ``hidden``, in both forms: the output, and on rank 0 the
    one-rank moe_mlp's."""
    from trace_tpu_torch.model.config import MoEConfig
    from trace_tpu_torch.model.moe import init_moe_mlp_params, moe_mlp

    cfg = dataclasses.replace(MoEConfig.mixtral_8x7b(), num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    lp = {k: v[0] for k, v in init_moe_mlp_params(cfg, gen, dtype=torch.bfloat16,
                                                  device="cuda").items()}
    n = cfg.num_experts // mesh.shape["model"]
    r = mesh.coord("model")
    local = {k: (v if k == "router" else v[r * n:(r + 1) * n]) for k, v in lp.items()}
    x = hidden.to("cuda")
    out = {}
    for form in ("dense", "sparse"):
        fcfg = dataclasses.replace(cfg, moe_impl=form)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep = moe_mlp(x, local, fcfg, group=mesh.group("model"))
        torch.cuda.synchronize()
        res = {"ep_s": time.perf_counter() - t0, "finite": bool(torch.isfinite(ep).all())}
        if rank == 0:
            one = moe_mlp(x, lp, fcfg)
            res.update(rel_err=rel_err(ep, one), max_abs_err=(ep.float() - one.float()).abs()
                       .max().item())
            print(f"parallel expert-parallel {form} (one Mixtral-8x7B layer, {n} experts a "
                  f"rank): {res['ep_s']:.3f} s, against the one-rank moe_mlp ||diff|| / "
                  f"||ref|| {res['rel_err']:.3g} (<= {EP_REL_TOL}), max abs "
                  f"{res['max_abs_err']:.3g}", flush=True)
        out[form] = res
    del lp, local
    torch.cuda.empty_cache()
    return out


def _pp_check(torch, pp_mesh, rank: int) -> dict:
    """pp_decoder_forward at full width, PP_LAYERS layers over the stages,
    PP_MICRO microbatches, B = 2 x PP_TOKENS, bf16, remat: the output and
    the gradients of a loss, then the same through decoder_forward on this
    rank alone, against which the rank holds its output, the embeddings'
    gradient and its own stage's layer gradients."""
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.mistral import decoder_forward
    from trace_tpu_torch.parallel.pipeline import pp_decoder_forward
    from trace_tpu_torch.params import _decoder, _Init
    from trace_tpu_torch.train.train import tree_paths

    cfg = dataclasses.replace(DecoderConfig(), num_layers=PP_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dec = _decoder(cfg, _Init(gen, torch.device("cuda"), torch.bfloat16))
    leaves = [x for _, x in tree_paths(dec["layers"])]
    for x in leaves:
        x.requires_grad_(True)
    B, T = 2, PP_TOKENS
    emb = torch.randn((B, T, cfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
    mask[1, T - 300:] = False  # a right-padded row, as training pads
    pos = (mask.long().cumsum(dim=1) - 1).clamp_min(0)
    w = torch.randn((B, T, cfg.hidden_size), generator=gen, device="cuda") / (B * T) ** 0.5
    per = PP_LAYERS // pp_mesh.shape["stage"]
    mine = slice(pp_mesh.coord("stage") * per, (pp_mesh.coord("stage") + 1) * per)

    def run(fn):
        e = emb.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(e)
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stripes = [x.grad[mine].clone() for x in leaves]  # this stage's layers
        for x in leaves:
            x.grad = None
        return out.detach(), e.grad, stripes, wall

    from trace_tpu_torch.parallel import collectives

    # the one-rank run first: it also takes the training path's first calls
    ref_out, ref_emb, ref_layers, one_s = run(
        lambda e: decoder_forward(dec, cfg, e, mask, pos, remat=True, trainable=True)[0])
    pp = lambda e: pp_decoder_forward(dec, cfg, e, mask, pos, mesh=pp_mesh,
                                      num_microbatches=PP_MICRO, remat=True)
    with torch.no_grad():  # the forward alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp(emb)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    before = kernel_counts()
    collectives.TIMING.update(on=True, seconds=0.0, calls=0)
    try:
        out, d_emb, d_layers, pp_s = run(pp)
    finally:
        collectives.TIMING["on"] = False
    got = count_delta(before)
    # per stage layer and microbatch: the forward's kernel, then in the
    # backward the recomputation with the logsumexp twice (the stage's, then
    # the layer checkpoint's) and the two backward kernels
    want = {"flash_attention": per * PP_MICRO, "flash_attention_fwd_res": 2 * per * PP_MICRO,
            "flash_attention_bwd_dq": per * PP_MICRO, "flash_attention_bwd_dkv": per * PP_MICRO}
    print(f"parallel rank {rank}, pipeline ({pp_mesh.shape['stage']} stages x {PP_MICRO} "
          f"microbatches, {PP_LAYERS} layers, B {B} x T {T}): forward alone {fwd_s:.3f} s, "
          f"forward + backward {pp_s:.3f} s, of which {collectives.TIMING['seconds']:.3f} s in "
          f"{collectives.TIMING['calls']} collectives; launches {got} expected {want}",
          flush=True)
    if got != want:
        fail(f"parallel pipeline, rank {rank}: launch counts {got} != expected {want}")
    num = den = 0.0
    for a, b in zip(d_layers, ref_layers):
        num += (a.float() - b.float()).square().sum().item()
        den += b.float().square().sum().item()
    res = {"pp_s": pp_s, "forward_s": fwd_s, "one_rank_s": one_s, "launches": got,
           "collective_s": collectives.TIMING["seconds"],
           "finite": bool(torch.isfinite(out).all() and torch.isfinite(d_emb).all()
                          and all(torch.isfinite(a).all() for a in d_layers)),
           "rel_err_out": rel_err(out, ref_out), "rel_err_d_embeds": rel_err(d_emb, ref_emb),
           "rel_err_d_layers": (num / den) ** 0.5}
    print(f"parallel rank {rank}, pipeline against decoder_forward on one rank "
          f"(||diff|| / ||ref||): output {res['rel_err_out']:.3g}, embedding gradients "
          f"{res['rel_err_d_embeds']:.3g}, stage {pp_mesh.coord('stage')}'s layer gradients "
          f"{res['rel_err_d_layers']:.3g} (<= {PP_REL_TOL}); {pp_s:.3f} s against {one_s:.3f} s "
          "on one rank (which took the process's first calls of the training path)", flush=True)
    del dec, leaves, d_layers, ref_layers
    torch.cuda.empty_cache()
    return res


def _lora_steps(torch, mesh, log: Path) -> tuple:
    """PAR_TRAIN_STEPS lora steps of train_loop at PAR_TRAIN_LAYERS layers on
    phase 6's data, over ``mesh`` (None: one rank): (wall s, the metrics
    records of the primary rank)."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.train.train import TrainRecipe, train_loop

    data = SyntheticVideos(TraceConfig(), SpmLikeTokenizer(), PAR_TRAIN_STEPS * VIDEOS)
    recipe = TrainRecipe(stage="lora", learning_rate=1e-4, total_steps=PAR_TRAIN_STEPS)
    params, cfg = train_params(torch, "lora", PAR_TRAIN_LAYERS)
    log.unlink(missing_ok=True)
    t0 = time.perf_counter()
    train_loop(params, cfg, data, recipe, batch_size=VIDEOS, mesh=mesh, log_every=1,
               metrics_path=str(log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    return wall, ([json.loads(x) for x in log.read_text().splitlines()] if log.exists() else [])


def _tp_train(torch, mesh, rank: int, tmp: Path) -> dict:
    """PAR_TRAIN_STEPS lora steps of train_loop(mesh=...) (the one-rank run
    that they are held to runs in the parent, alone on the card)."""
    before = kernel_counts()
    # a log a rank: only the primary writes, and each run first clears its log
    wall, recs = _lora_steps(torch, mesh, tmp / f"par_train_mesh_{rank}.jsonl")
    res = {"wall_s": wall, "launches": count_delta(before)}
    if rank == 0:
        res["losses"] = [r["loss"] for r in recs]
        res["grad_norms"] = [r["grad_norm"] for r in recs]
    return res


def _par_rank(rank: int, world: int, port: int, tmp: str) -> None:
    """One rank of phase 11 (spawned; it writes its results to ``tmp``)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise RuntimeError("phase 11: a rank found no CUDA device")
    torch.cuda.set_device(0)
    from trace_tpu_torch.parallel.pipeline import build_pp_mesh
    from trace_tpu_torch.runtime.distributed import initialize
    from trace_tpu_torch.runtime.mesh import build_mesh

    # gloo over CUDA tensors: the ranks share the one card, and NCCL refuses
    # two ranks on one device
    initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = build_mesh(world, model_axis=world)   # data 1 x model 2, on the card
    pp_mesh = build_pp_mesh(world)               # 2 stages
    out = {"rank": rank, "mesh": mesh.shape, "serving": {}}
    t0 = time.perf_counter()
    for mode in ("bf16", "int8"):
        out["serving"][mode] = _tp_serving(torch, mesh, mode, rank)
    out["serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["int4"] = _tp_int4(torch, mesh, rank)
    out["int4_s"] = time.perf_counter() - t0
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.quantize import quantize_decoder_params
    from trace_tpu_torch.params import _decoder, _Init
    from trace_tpu_torch.runtime.generate import generate_sharded
    from trace_tpu_torch.runtime.mesh import shard_params_for_inference

    small = DecoderConfig.tiny()
    packed = quantize_decoder_params(_decoder(small, _Init(
        torch.Generator(device="cuda").manual_seed(SEED), torch.device("cuda"),
        torch.bfloat16)), bits=4, pack=True)
    x = torch.zeros((2, 8, small.hidden_size), dtype=torch.bfloat16, device="cuda")
    try:
        generate_sharded(shard_params_for_inference(packed, mesh), small, x,
                         torch.ones((2, 8), dtype=torch.bool, device="cuda"),
                         torch.zeros((small.combined_vocab_size, small.hidden_size),
                                     dtype=torch.bfloat16, device="cuda"), mesh=mesh)
        out["int4p_refused"] = None
    except ValueError as e:
        out["int4p_refused"] = str(e)
    t0 = time.perf_counter()
    out["moe"] = _ep_check(torch, mesh, rank, torch.load(Path(tmp) / "moe_hidden.pt"))
    out["moe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["pp"] = _pp_check(torch, pp_mesh, rank)
    out["pp_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = _tp_train(torch, mesh, rank, Path(tmp))
    out["train_phase_s"] = time.perf_counter() - t0
    torch.save(out, Path(tmp) / f"par_rank{rank}.pt")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def parallel_phase(torch, tmp: Path) -> tuple:
    """Phase 11: PAR_RANKS ranks on the one card, a gloo group over CUDA
    tensors (see ``_par_rank``), each of the port's parallel paths driven and
    held to its one-rank path; returns (rank 0's launches on the parallel
    paths: the second request of each serving mode, the pipeline run and
    the lora steps, the stats)."""
    import socket

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    refs = {}
    for mode in ("bf16", "int8"):
        refs[mode] = first_token_refs(torch, mode)
    hidden = STASH.get("moe_hidden")
    source = "phase 10's padded prefill"
    if hidden is None:  # --parallel alone: a seeded hidden of that shape
        g = torch.Generator().manual_seed(SEED)
        hidden = torch.randn((VIDEOS * 2048, 4096), generator=g).to(torch.bfloat16)
        source = "a seeded normal hidden of phase 10's padded prefill shape"
    torch.save(hidden.reshape(VIDEOS, -1, hidden.shape[-1]), tmp / "moe_hidden.pt")
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(_par_rank, args=(PAR_RANKS, port, str(tmp)), nprocs=PAR_RANKS,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > PAR_TIMEOUT_S:
                fail(f"phase 11: the ranks did not finish in {PAR_TIMEOUT_S} s")
    except Exception as e:  # noqa: BLE001 - a rank raised or died
        fail(f"phase 11: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"par_rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]
    r0 = ranks[0]
    stats = {"ranks_s": ranks_s, "moe_hidden": source, "per_rank": []}
    print(f"phase 11: the expert-parallel layer's input is {source}", flush=True)
    for r in ranks:
        for mode, sv in r["serving"].items():
            req = sv["requests"][1]
            c = sv["collectives"]
            print(f"parallel rank {r['rank']} {mode}: init + shard {sv['init_s']:.1f} s; second "
                  f"request: encode {req['encode_s']:.3f} s, prefill {req['prefill_s']:.3f} s, "
                  f"decode {1e3 * req['decode_s'] / max(req['decode_steps'], 1):.2f} ms/step; "
                  f"gloo collectives {100 * c['share_of_decode']:.1f} % of the first request's "
                  f"decode loop ({c['collective_calls']} calls, {c['collective_s']:.3f} s)",
                  flush=True)
        stats["per_rank"].append({
            "rank": r["rank"], "serving_s": r["serving_s"], "moe_s": r["moe_s"],
            "pp_phase_s": r["pp_phase_s"], "train_phase_s": r["train_phase_s"],
            "serving": {m: {k: v for k, v in sv.items() if k != "first_logits"}
                        for m, sv in r["serving"].items()}})
    # the ranks agree, and the first-token logits are no further from the
    # fp32 model than the one-rank kernel path's
    for mode in ("bf16", "int8"):
        toks = [r["serving"][mode]["requests"][1]["tokens"] for r in ranks]
        if any(t != toks[0] for t in toks):
            fail(f"parallel {mode}: the ranks returned different tokens")
        tp = r0["serving"][mode]["first_logits"]
        if not torch.isfinite(tp).all():
            fail(f"parallel {mode}: non-finite first-token logits")
        e = rel_err(tp, refs[mode]["fp32_logits"])
        one = refs[mode]["kernel_vs_fp32"]
        near = rel_err(tp, refs[mode]["kernel_logits"])
        stats[f"{mode}_logits_vs_fp32"] = {"tensor_parallel": e, "one_rank_kernel": one,
                                           "tensor_parallel_vs_one_rank": near}
        print(f"parallel {mode} ({PAR_SERVE_LAYERS} layers): first-token logits from the fp32 "
              f"model (||diff|| / ||ref||): tensor-parallel {e:.5f}, one-rank kernel path "
              f"{one:.5f} (tol: tensor-parallel <= {REF_RATIO_TOL} x one-rank); tensor-parallel "
              f"from one-rank {near:.3g}", flush=True)
        if not e <= REF_RATIO_TOL * one:
            fail(f"parallel {mode}: the tensor-parallel logits are further from the fp32 model "
                 "than the one-rank kernel path's")
    if not all(r["int4p_refused"] and "single-chip only" in r["int4p_refused"] for r in ranks):
        fail("parallel: an int4p tree was not refused")
    # the int4 request: the ranks agree, each is held to its one-rank request
    i4 = r0["int4"]
    lead = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            for a, b in zip(i4["tokens"], i4["one_rank_tokens"])]
    stats["int4"] = {k: v for k, v in i4.items() if k not in ("tokens", "one_rank_tokens")}
    stats["int4"].update(seconds=r0["int4_s"], tokens_agree_with_one_rank=lead)
    print(f"parallel int4 ({TP_INT4_LAYERS} layers, model {PAR_RANKS}): {r0['int4_s']:.1f} s; "
          f"first-token logits from one rank's {i4['logits_vs_one_rank']:.3g} (tol "
          f"{TP_INT4_TOL}); greedy tokens equal one rank's for the first {lead} of {MAX_NEW} "
          "per row", flush=True)
    if any(r["int4"]["tokens"] != i4["tokens"] for r in ranks):
        fail("parallel int4: the ranks returned different tokens")
    if not (i4["finite"] and i4["logits_vs_one_rank"] <= TP_INT4_TOL and min(lead) >= 1):
        fail("parallel int4: the tensor-parallel request is not held to one rank's")
    for form, m in r0["moe"].items():
        if not (all(r["moe"][form]["finite"] for r in ranks) and m["rel_err"] <= EP_REL_TOL):
            fail(f"parallel expert-parallel {form}: disagrees with the one-rank layer")
    for r in ranks:
        pp = r["pp"]
        if not (pp["finite"] and max(pp["rel_err_out"], pp["rel_err_d_embeds"],
                                     pp["rel_err_d_layers"]) <= PP_REL_TOL):
            fail(f"parallel pipeline, rank {r['rank']}: disagrees with decoder_forward")
    pp = r0["pp"]
    tr = r0["train"]
    tr["one_rank_wall_s"], one = _lora_steps(torch, None, tmp / "par_train_one.jsonl")
    tr["one_rank_losses"] = [x["loss"] for x in one]
    tr["one_rank_grad_norms"] = [x["grad_norm"] for x in one]
    gap = lambda a, b: max((abs(x - y) / abs(y) for x, y in zip(a, b)), default=math.inf)
    tr["loss_rel_gap"] = gap(tr["losses"], tr["one_rank_losses"])
    tr["grad_norm_rel_gap"] = gap(tr["grad_norms"], tr["one_rank_grad_norms"])
    print(f"parallel lora steps at {PAR_TRAIN_LAYERS} layers, model {PAR_RANKS}: losses "
          f"{tr['losses']} against one rank's {tr['one_rank_losses']}, largest |diff| / |one "
          f"rank's| {tr['loss_rel_gap']:.3g} (<= {PAR_LOSS_RTOL}); grad norms "
          f"{tr['grad_norms']} against {tr['one_rank_grad_norms']}, "
          f"{tr['grad_norm_rel_gap']:.3g} (<= {PAR_NORM_RTOL}); {tr['wall_s']:.2f} s against "
          f"{tr['one_rank_wall_s']:.2f} s", flush=True)
    counts = {len(tr[k]) for k in ("losses", "one_rank_losses", "grad_norms",
                                   "one_rank_grad_norms")}
    if counts != {PAR_TRAIN_STEPS} or not all(
            math.isfinite(x) for x in tr["losses"] + tr["grad_norms"]):
        fail(f"parallel lora steps: not {PAR_TRAIN_STEPS} finite losses and grad norms a run")
    if tr["losses"][-1] == tr["losses"][0] and tr["grad_norms"][-1] == tr["grad_norms"][0]:
        fail("parallel lora steps: the update moved nothing")
    if not (tr["loss_rel_gap"] <= PAR_LOSS_RTOL and tr["grad_norm_rel_gap"] <= PAR_NORM_RTOL):
        fail("parallel lora steps: a loss or a grad norm is not within its limit of one rank's")
    launches = {}
    for part in ([r0["serving"][m]["requests"][1]["launches"] for m in ("bf16", "int8")]
                 + [i4["launches"], pp["launches"], tr["launches"]]):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    stats.update(moe=r0["moe"], pp=pp, train=tr, launches=launches,
                 seconds=time.perf_counter() - t_phase)
    print(f"phase 11: {stats['seconds']:.1f} s ({ranks_s:.1f} s the ranks); launches on rank 0 "
          f"{launches}", flush=True)
    return launches, stats


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "trace_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = device_line()
    print(card, flush=True)

    from trace_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {len(build.SOURCES)} CUDA sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    if sys.argv[1:] == ["--families"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(families_phase(torch, Path(tmp))[1]), flush=True)
        return 0
    if sys.argv[1:] == ["--moe"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(moe_phase(torch, Path(tmp))[1]), flush=True)
        return 0
    if sys.argv[1:] == ["--parallel"]:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(parallel_phase(torch, Path(tmp))[1]), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--runbook"]:
        with tempfile.TemporaryDirectory() as tmp:
            return runbook(torch, Path(tmp))
    if sys.argv[1:] in (["--checkpoint"], ["--eval"]):
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_stats = checkpoint_phase(torch, Path(tmp))[1]
            if sys.argv[1:] == ["--eval"]:
                ckpt_stats["eval"] = eval_phase(torch, Path(tmp),
                                                ckpt_stats["container_reader"])
            print(json.dumps(ckpt_stats), flush=True)
        return 0
    rows = kernel_checks(torch)
    if sys.argv[1:] == ["--kernels"]:
        print(json.dumps({name: {k: v for k, v in r.items()} for name, r in rows.items()}))
        return 0
    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's launches are those of the first path that runs it
    launches, stats, e2e = {}, [], {}
    elapsed = lambda phase: print(f"chip_smoke: phase {phase} done at "
                                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
    elapsed(3)
    modes = ("bf16", "int8", "int4p", "int4p_g0")
    for mode in modes:
        counts, mode_stats, e2e[mode] = end_to_end(torch, mode)
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)  # of the first path that runs the kernel
        stats += mode_stats
    f32_launches, f32_trees_stats = fp32_trees(torch)
    for name, n in f32_launches.items():
        launches.setdefault(name, n)
    e2e["fp32_trees"] = f32_trees_stats
    elapsed(4)
    corpus_launches, corpus = corpus_phase(torch)
    elapsed(5)
    for name, n in corpus_launches.items():
        launches.setdefault(name, n)
    with tempfile.TemporaryDirectory() as tmp:  # the loops' metrics logs
        train_launches, train_stats, grad_check = training(torch, Path(tmp))
    elapsed(6)
    for name, n in train_launches.items():
        launches.setdefault(name, n)
    with tempfile.TemporaryDirectory() as tmp:  # the checkpoint, videos, JSONL, eval files
        ckpt_launches, ckpt_stats = checkpoint_phase(torch, Path(tmp))
        eval_stats = eval_phase(torch, Path(tmp), ckpt_stats["container_reader"])
    elapsed("7-8")
    for name, n in ckpt_launches.items():
        if n:
            launches.setdefault(name, n)
    with tempfile.TemporaryDirectory() as tmp:  # the two checkpoints
        family_launches, family_stats = families_phase(torch, Path(tmp))
    elapsed(9)
    launches.update(family_launches)  # the G = 7 rows: launched on this path alone
    with tempfile.TemporaryDirectory() as tmp:  # the Mixtral checkpoint and an .npy
        moe_launches, moe_stats = moe_phase(torch, Path(tmp))
    elapsed(10)
    with tempfile.TemporaryDirectory() as tmp:  # the ranks' inputs, logs and results
        par_launches, par_stats = parallel_phase(torch, Path(tmp))
    elapsed(11)
    second = stats[1::2]  # the second request of each path
    per_step = lambda s: 1e3 * s["decode_s"] / max(s["decode_steps"], 1)
    col = lambda f: " | ".join(f(s) for s in second)
    print(f"second requests, {' | '.join(modes)} ({INT4P_LAYERS} and {G0_LAYERS} layers): "
          f"encode {col(lambda s: format(s['encode_s'], '.3f'))} s, "
          f"prefill {col(lambda s: format(s['prefill_s'], '.3f'))} s, "
          f"decode {col(lambda s: format(per_step(s), '.2f'))} ms/step", flush=True)

    sources = {
        "flash_attention": ("trace_tpu_torch/kernels/csrc/attention.cu",
                            "trace_tpu/kernels/flash_attention.py:112"),
        "vit_attention_btd": ("trace_tpu_torch/kernels/csrc/attention.cu",
                              "trace_tpu/kernels/flash_attention.py:209"),
        "decode_attention": ("trace_tpu_torch/kernels/csrc/decode_attention.cu",
                             "trace_tpu/kernels/decode_attention.py:288"),
        "quant_matmul": ("trace_tpu_torch/kernels/csrc/quant_matmul.cu",
                         "trace_tpu/kernels/quant_matmul.py:320"),
        "quant_matmul_stacked": ("trace_tpu_torch/kernels/csrc/quant_matmul.cu",
                                 "trace_tpu/kernels/quant_matmul.py:418"),
        "quant_matmul_wide": ("trace_tpu_torch/kernels/csrc/quant_matmul.cu",
                              "trace_tpu/kernels/quant_matmul.py:320"),
        "quant_matmul_stacked_wide": ("trace_tpu_torch/kernels/csrc/quant_matmul.cu",
                                      "trace_tpu/kernels/quant_matmul.py:418"),
        "decode_attention_int8_s8dot": (
            "trace_tpu_torch/kernels/csrc/decode_attention_int8.cu",
            "trace_tpu/kernels/decode_attention.py:288 (bodies :97, :145)"),
        "decode_attention_int8_dequant": (
            "trace_tpu_torch/kernels/csrc/decode_attention_int8.cu",
            "trace_tpu/kernels/decode_attention.py:288 (body :68)"),
        "decode_attention_g7": ("trace_tpu_torch/kernels/csrc/decode_attention.cu",
                                "trace_tpu/kernels/decode_attention.py:288 (body :47)"),
        "decode_attention_int8_s8dot_g7": (
            "trace_tpu_torch/kernels/csrc/decode_attention_int8.cu",
            "trace_tpu/kernels/decode_attention.py:288 (bodies :97, :145)"),
        "decode_attention_int8_dequant_g7": (
            "trace_tpu_torch/kernels/csrc/decode_attention_int8.cu",
            "trace_tpu/kernels/decode_attention.py:288 (body :68)"),
        "quant_matmul_p4": ("trace_tpu_torch/kernels/csrc/quant_matmul_p4.cu",
                            "trace_tpu/kernels/quant_matmul.py:133"),
        "quant_matmul_p4_mma": ("trace_tpu_torch/kernels/csrc/quant_matmul_p4.cu",
                                "trace_tpu/kernels/quant_matmul.py:133"),
        "quant_matmul_p4_grouped": ("trace_tpu_torch/kernels/csrc/quant_matmul_p4.cu",
                                    "trace_tpu/kernels/quant_matmul.py:239"),
        "quant_matmul_p4_grouped_mma": ("trace_tpu_torch/kernels/csrc/quant_matmul_p4.cu",
                                        "trace_tpu/kernels/quant_matmul.py:239"),
        "flash_attention_fwd_res": ("trace_tpu_torch/kernels/csrc/attention.cu",
                                    "trace_tpu/kernels/flash_backward.py:172"),
        "flash_attention_bwd_dq": ("trace_tpu_torch/kernels/csrc/attention_bwd.cu",
                                   "trace_tpu/kernels/flash_backward.py:228"),
        "flash_attention_bwd_dkv": ("trace_tpu_torch/kernels/csrc/attention_bwd.cu",
                                    "trace_tpu/kernels/flash_backward.py:252"),
    }
    # the rows at hd 100 (phase 9's open_llama_3b path): the same TPU kernels
    # (the JAX package pads hd there, or decodes through XLA's einsum); the
    # decode rows' padded instances in the *_pad.cu twins of their sources
    for base in HD100_ROWS:
        src, replaces = sources[base]
        sources[f"{base}_hd100"] = (
            src.replace(".cu", "_pad.cu") if base.startswith("decode") else src, replaces)
    # the rows at hd 256 (phase 9's Falcon3 path): the same TPU kernels (the
    # JAX package runs its Pallas kernels at hd 256); the decode rows' and
    # the backward's width-256 instances in the *_256.cu twins of their
    # sources
    for base in HD256_ROWS:
        src, replaces = sources[base]
        sources[f"{base}_hd256"] = (
            src.replace(".cu", "_256.cu") if base.startswith(("decode", "flash_attention_bwd"))
            else src, replaces)
    # the fp32 forms: their own sources (the decode rows: fp32 instances in
    # the bf16 rows' sources), the same TPU kernels
    f32_sources = {"flash_attention": "attention_f32.cu", "vit_attention_btd": "attention_f32.cu",
                   "flash_attention_fwd_res": "attention_f32.cu",
                   "flash_attention_bwd_dq": "attention_bwd_f32.cu",
                   "flash_attention_bwd_dkv": "attention_bwd_f32.cu",
                   "decode_attention": "decode_attention.cu",
                   "decode_attention_int8_s8dot": "decode_attention_int8.cu",
                   "decode_attention_int8_dequant": "decode_attention_int8.cu",
                   "quant_matmul": "quant_matmul.cu",
                   "quant_matmul_stacked": "quant_matmul.cu",
                   "quant_matmul_p4": "quant_matmul_p4.cu",
                   "quant_matmul_p4_grouped": "quant_matmul_p4.cu"}
    for base, src in f32_sources.items():
        for name in (f"{base}_f32", f"{base}_f32_tiled"):
            if name in rows:  # the weight products' tensor-core form: quant_matmul_f32.cu
                tiled = name.endswith("_tiled")
                sources[name] = (f"trace_tpu_torch/kernels/csrc/"
                                 f"{'quant_matmul_f32.cu' if tiled else src}", sources[base][1])
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches.get(name, 0),
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"],
         # the corpus phase's own count (pass A), beside the first path's
         "launches_corpus": corpus_launches.get(name, 0),
         # the Mixtral path's own (phase 10: the second request of each
         # serving form, the two lora steps)
         "launches_moe": moe_launches.get(name, 0),
         # the parallel paths' on rank 0 (phase 11: the second request of
         # each tensor-parallel serving mode, the pipeline run, the lora steps)
         "launches_parallel": par_launches.get(name, 0)}
        for name, r in rows.items()
    ]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        fail(f"no path launched {idle}")
    print(json.dumps({"requests": stats, "e2e": e2e, "corpus": corpus, "training": train_stats,
                      "gradient_check": grad_check, "checkpoint": ckpt_stats,
                      "eval": eval_stats, "families": family_stats, "moe": moe_stats,
                      "parallel": par_stats,
                      "card": card,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
