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
     flash backend on the same q / k / v with is_causal and no bias;
  4. the TRACE-7B serving path end to end at full width (CLIP ViT-L/14-336
     at the -2 tap, spatial_slot, Mistral-7B, random weights from seed 0),
     first in bf16, then in the int8 serving configuration (int8 weights in
     the fused layout, int8 KV cache, W8A8 prefill and ViT), then in the
     int4p serving configuration (nibble-packed int4 layer weights with
     group-128 scales, weight-only at every chunk length): two requests
     of 2 synthetic 128-frame 336x336 videos, 64 new tokens each, launch
     counts checked per request, outputs checked against the same path with
     every kernel replaced by its plain version and against an fp32 model
     of the same (dequantized) weights. Last the same on a per-channel
     (group 0) int4p tree at a depth of 4 layers (W4A8 prefill, the
     per-channel kernel in the steps), and one request of it without
     activation quantization (the per-channel kernel in the prefill too).
  5. the bench's default serving workload (bench.py's defaults) through the
     port's entry points at full width: TRACE-7B in the int8 serving
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
     (rank 128 on the seven decoder projections), then stage ``sft`` at a
     depth of 4 layers. Per stage a 1-step run (the schedule starts at 0: no
     trainable leaf may move), a 2-step run (every trainable group must have
     moved) and the 4-step run that is timed: losses finite, frozen leaves
     bit-equal before and after, launch counts per step as the code implies,
     peak memory printed; one ``pretrain`` step under torch.profiler, with
     the device time of the training attention kernels in it. Last, at
     the 4-layer depth, one forward_train + backward through the kernels
     against the same with every kernel replaced by its plain version and
     against an fp32 model of the same weights: the loss and the gradients of
     the connector, the towers and decoder layer 0.
  7. a TRACE-7B checkpoint of the released merged layout (690 keys, bf16,
     random values) written to a temporary directory and served through the
     public API: ``model_init`` in bf16 and int8, ``infer_events`` on an
     ``.npy`` of 256 640x360 frames, ``serve`` over four such files and one
     that does not load (see ``checkpoint_phase``).
  8. the evaluation entry points on that checkpoint and those videos
     (``eval_phase``): ``eval.evaluate.main`` for tvg in bf16,
     ``runtime.inference.main``, ``run_vtg_eval`` for dvc in int8 scored
     as dvc, dvc-anet and vhd, and ``run_mvbench`` on JPEG frame dumps.
The line before the last is {"kernels": [...]} (each entry also holds
``launches_corpus``, its count in phase 5's pass A); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it prints no result and exits 2. ``--kernels`` stops
after phase 3 (a short check of freshly edited kernels; no last line);
``--checkpoint`` runs phase 7 alone and ``--eval`` phases 7 and 8 (each
after the build; no last line).
"""

from __future__ import annotations

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
    "quant_matmul_p4": (1e-5, 2 ** -7),          # split-K form, units of max |ref|
    "quant_matmul_p4_mma": (1e-4, 2 ** -7),      # tensor-core form, same units
    "quant_matmul_p4_grouped": (1e-5, 2 ** -7),
    "quant_matmul_p4_grouped_mma": (1e-4, 2 ** -7),
}
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
    # left-padded rows see no key: finite, unspecified; compare real rows
    cmp = compare("flash_attention", torch.cat([out[0, :, PAD:], out[1]], dim=1),
                  torch.cat([ref[0, :, PAD:], ref[1]], dim=1))
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
    packed_int4_checks(torch, g, rows)
    flash_backward_checks(torch, g, rows)

    for name, r in rows.items():
        atol, rtol = KERNEL_TOL[name]
        print(f"kernel {name}: max_abs_err={r['err']:.6f} (|diff| <= {atol} + "
              f"{rtol} |ref|, excess {r['excess']:.6f}) rel_norm_err="
              f"{r['rel_norm']:.6f} (tol {REL_NORM_TOL}) ref_rms={r['ref_rms']:.4f} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL):
            fail(f"{name}: kernel disagrees with its plain version")
    return rows


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


def _serving_kernels():
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.kernels import quant_matmul as qm

    return (flash_attention, vit_attention_btd, decode_attention, qm.quant_matmul,
            qm.quant_matmul_stacked, qm.quant_matmul_p4, qm.quant_matmul_p4_grouped)


def reset_serving_launches() -> None:
    """Every launch count of the serving kernels set to 0."""
    fa, vit, da, qmm, qmm_stacked, p4, p4g = _serving_kernels()
    for fn in (fa, vit, da, qmm, qmm_stacked, p4, p4g):
        fn.launches = 0
    for m in da.launches_int8:
        da.launches_int8[m] = 0
    for fn in (p4, p4g):
        fn.launches_by_form.update(splitk=0, mma=0)
    for fn in (qmm, qmm_stacked):
        fn.launches_by_form.update(splitk=0, wide=0)


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
            "quant_matmul_p4_grouped_mma": p4g.launches_by_form["mma"]}


def end_to_end(torch, mode: str):
    """Phase 4: the serving path at full width, two requests, in the bf16
    (``mode="bf16"``), the int8 (``"int8"``) or the int4p serving
    configuration with group-128 scales (``"int4p"``); ``"int4p_g0"`` is the
    int4p configuration with per-channel scales at a depth of G0_LAYERS."""
    import numpy as np

    from trace_tpu_torch import EventPredictions
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.mistral import compute_logits
    from trace_tpu_torch.model.quantize import int4p_serving, int8_serving
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    int8 = mode == "int8"
    quantized = mode != "bf16"  # int8 KV cache, int8 lm_head, W8A8 ViT
    cfg = TraceConfig()
    if mode == "int4p_g0":
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, num_layers=G0_LAYERS))
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
    rng = np.random.default_rng(SEED)
    videos = [rng.integers(0, 256, (FRAMES, 336, 336, 3), dtype=np.uint8)
              for _ in range(VIDEOS)]
    stamps = [[[float(i)] for i in range(FRAMES)]] * VIDEOS
    asks = ["Localize the visual events in the video and describe each one.",
            "Find every moment where something changes, with timestamps."]
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
    (prefix, mask), encode_profile = device_profile(
        torch, f"{mode} encode (ViT + connector + splice)",
        lambda: pipe.encode_prefix(videos, stamps, asks))
    if not torch.isfinite(prefix).all():
        fail("non-finite prefix embeddings")
    prefixes = {"kernel": prefix, "plain": plain.encode_prefix(videos, stamps, asks)[0],
                "fp32": ref.encode_prefix(videos, stamps, asks)[0]}

    P = prefix.shape[1]
    bucket = -(-P // 128) * 128
    pe = torch.nn.functional.pad(prefix, (0, 0, bucket - P, 0))
    pm = torch.nn.functional.pad(mask, (bucket - P, 0))
    logits = {}
    for name, p, impl in (("kernel", pipe, "auto"), ("plain", plain, "plain"),
                          ("fp32", ref, "plain")):
        x = pe.float() if name == "fp32" else pe
        prefill = lambda: gen.prefill(p._decoder_params, p.config.decoder, x, pm,
                                       cache_len=bucket + 1, impl=impl)
        if name == "kernel":
            state, prefill_profile = device_profile(torch, f"{mode} prefill", prefill)
        else:
            state = prefill()
        logits[name] = compute_logits(p._decoder_params, state[2], impl=impl)
        if name == "kernel":
            step_profile = profile_decode_step(torch, pipe, cfg.decoder, state, mode)
        del state
    del ref
    if not torch.isfinite(logits["kernel"]).all():
        fail("non-finite logits")
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
    del pipe, plain, params
    torch.cuda.empty_cache()
    return launches, stats, {**errs, "greedy_agree": agree, "decode_step": step_profile,
                             "encode_profile": encode_profile,
                             "prefill_profile": prefill_profile}


CORPUS_VIDEOS = 64      # two decode chunks of CORPUS_BATCH
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
    """Check (e): ``run()`` with the entries of rows 1, 2, 3, 3b, 4 and 5
    watched where the model calls them (the attention wrappers; for the
    int8 weight products ``quant_apply`` and ``quant_apply_stacked``, which
    hand an int8 leaf to ``quant_matmul`` and ``quant_matmul_stacked``). The
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
        """The row a call runs, or None for a call that reaches no kernel."""
        if attr.startswith("quant_apply"):
            int8 = isinstance(a[1], dict) and "q" in a[1]
            wide = a[0].numel() // a[0].shape[-1] > SPLIT_ROWS  # rows of x
            return ("quant_matmul" + attr[len("quant_apply"):] + "_wide" * wide) if int8 else None
        if attr == "decode_attention" and isinstance(a[1], dict):
            return f"decode_attention_int8_{k.get('mode', 's8dot')}"
        return attr

    def held(name, a, out, ref):
        if name.startswith("quant_matmul"):
            unit = ref.abs().max()
            r = compare(name, out.float() / unit, ref.float() / unit)
            r["err"] *= unit.item()
            return r
        if name == "vit_attention_btd":
            tq = a[3]
            return compare(name, out[:, :tq], ref[:, :tq])
        seen = a[3] > -1e29  # [B, T] or [B, S]: the visible keys
        if name == "flash_attention":  # causal: row t sees keys <= t
            rows = seen.int().cumsum(-1) > 0
            pick = lambda o: o.transpose(1, 2)[rows]
            return compare(name, pick(out), pick(ref))
        rows = seen.any(-1)
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
        print(f"corpus check (e), {label}: {r['name']} on [{r['shapes']}]: max_abs_err="
              f"{r['err']:.6g} excess={r['excess']:.3g} (|diff| <= {atol} + {rtol} |ref|) "
              f"rel_norm_err={r['rel_norm']:.3g} (<= {REL_NORM_TOL})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL):
            bad.append(f"{r['name']} on [{r['shapes']}]")
    if bad:
        fail(f"corpus (e), {label}: kernel and plain version disagree on the path's "
             f"inputs: {bad}")
    return out, {f"{r['name']} [{r['shapes']}]": {k: r[k] for k in ("err", "excess", "rel_norm")}
                 for r in results.values()}


def corpus_phase(torch):
    """Phase 5: the bench's default serving workload through the port's
    entry points (``prepare_sample_host_np`` -> ``infer_events_corpus``) at
    full width, with checks (a)-(e) of the module docstring."""
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
    print(f"corpus: int8 TRACE-7B (yuv420) ready in {t1 - t0:.1f} s; {CORPUS_POOL} videos "
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


def train_params(torch, stage: str, layers: int):
    """(params, config) of a stage from SEED: TRACE-7B at ``layers`` decoder
    layers; stage ``lora`` adds rank-128 fp32 adapters on the seven decoder
    projections, as the training CLI does."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.lora import add_lora_params
    from trace_tpu_torch.params import init_trace_params

    cfg = TraceConfig()
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
    """Phase 6: stages pretrain and lora at full depth, sft at SFT_LAYERS
    layers, then the gradient check on the sft model."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    tok = SpmLikeTokenizer()
    data = SyntheticVideos(TraceConfig(), tok, VIDEOS)
    launches, stats = {}, []
    full = TraceConfig().decoder.num_layers
    check = None
    for stage, layers in (("pretrain", full), ("lora", full), ("sft", SFT_LAYERS)):
        params, cfg, got, st = train_stage(torch, stage, layers, data, tmp)
        for name, n in got.items():
            if n:
                launches.setdefault(name, n)  # over the stage's TRAIN_STEPS-step run
        stats.append(st)
        if stage == "sft":
            check = gradient_check(torch, params, cfg, data)
        del params
        torch.cuda.empty_cache()
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
    ``init_trace_params``), from a generator seeded with SEED + 1 + index."""
    if key.endswith(("norm.weight", "layer_norm1.weight", "layer_norm2.weight",
                     "ln_vision.weight")):
        return torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    if key.endswith(".bias"):
        return torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1 + index)
    scale = 1.0 if key.endswith(".slots") else 0.02
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


def write_checkpoint(torch, path: Path, keys, cfg) -> int:
    """The merged checkpoint dir: ``keys`` [(key, shape)] in manifest order
    over shards of about CKPT_SHARD_BYTES, and a config.json of ``cfg``'s
    geometry (scripts/parity/manifest.py ``_released_config``). Returns the
    bytes of tensor data."""
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
        "architectures": ["TraceMistralForCausalLM"], "model_type": "mistral",
        "vocab_size": d.vocab_size, "hidden_size": d.hidden_size,
        "intermediate_size": d.intermediate_size, "num_hidden_layers": d.num_layers,
        "num_attention_heads": d.num_heads, "num_key_value_heads": d.num_kv_heads,
        "head_dim": d.head_dim, "rope_theta": d.rope_theta, "rms_norm_eps": d.rms_eps,
        "time_vocab_size": d.time_vocab_size, "score_vocab_size": d.score_vocab_size,
        "mm_projector_type": cfg.mm_projector_type, "num_slots": cfg.num_slots,
        "num_frames": cfg.num_frames, "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_vision_tower": "openai/clip-vit-large-patch14-336", "torch_dtype": "bfloat16"}))
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


def checkpoint_phase(torch, tmp: Path) -> tuple:
    """Phase 7: write the TRACE-7B checkpoint, then (a) ``model_init`` bf16:
    every key read once, every leaf's shape and dtype those of
    ``init_trace_params``, sampled leaves bit-equal to the bytes written, the
    tree on the card; (b) ``model_init`` int8: its decoder bit-equal to
    ``quantize_decoder_params`` + ``fuse_decoder_serving`` of (a)'s tree on
    the card, the set-up's peak card memory; (c) ``infer_events`` on an
    ``.npy`` video: EventPredictions, the rows of the path launched, no plain
    version on the card, the same tokens as ``infer_events_from_frames`` on
    ``load_video_frames``' output, whose kernels are held against their
    plain versions (check (e) of phase 5); (d) ``serve`` over the videos and
    a file that does not load: one JSONL line each, one of them an error."""
    import gc
    import shutil

    import numpy as np

    from trace_tpu_torch import EventPredictions, infer_events
    from trace_tpu_torch.checkpoint import convert
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import fuse_decoder_serving, quantize_decoder_params
    from trace_tpu_torch.native import videodec
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime import pipeline as pl
    from trace_tpu_torch.runtime.serve_batch import serve
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer
    from trace_tpu_torch.video.io import load_video_frames

    gib = lambda n: n / 2 ** 30
    t_phase = time.perf_counter()
    stats = {}
    try:
        videodec.load()
        stats["native_decoder"] = "built: FFmpeg's libraries are on this machine"
    except videodec.NativeDecoderUnavailable as e:
        stats["native_decoder"] = f"not available ({str(e).splitlines()[0]})"
    meminfo = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    stats["host"] = {"disk_free_gib": gib(shutil.disk_usage(tmp).free),
                     "ram_available_gib": int(meminfo["MemAvailable"].split()[0]) / 2 ** 20,
                     "ram_total_gib": int(meminfo["MemTotal"].split()[0]) / 2 ** 20}
    print(f"checkpoint: native video decoder {stats['native_decoder']}; host: "
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
            if quant == "int8":  # (a)'s decoder quantized on the card: (b)'s reference
                t0 = time.perf_counter()
                ref = fuse_decoder_serving(quantize_decoder_params(pipe.params["decoder"]))
                ref = {"layers": {n: ref["layers"][n] for n in ("wqkv", "wo", "w_gateup", "w_down")},
                       "lm_head": ref["lm_head"]}
                torch.cuda.synchronize()
                stats["card_quantize_s"] = time.perf_counter() - t0
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

    # (c) infer_events on a video file, then the same frames with the kernels held
    rng = np.random.default_rng(SEED)
    videos = []
    for v in range(CKPT_VIDEOS):
        videos.append(tmp / f"video{v}.npy")
        np.save(videos[-1], rng.integers(0, 256, (CKPT_VIDEO_FRAMES,) + CORPUS_HW + (3,),
                                         dtype=np.uint8))
    (tmp / "broken.npy").write_bytes(b"not a numpy file")
    reset_serving_launches()
    plain_counts, undo = watch_plain(torch)
    try:
        t0 = time.perf_counter()
        pred = infer_events(pipe, str(videos[0]), CORPUS_ASK, max_new_tokens=CKPT_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    launches = serving_launches()
    tokens = pipe.last_stats["tokens"]
    plain = {k: v for k, v in plain_counts.items() if v}
    s = pipe.last_stats
    stats["request"] = {"wall_s": wall, "encode_s": s["encode_s"], "prefill_s": s["prefill_s"],
                        "decode_s": s["decode_s"], "decode_steps": s["decode_steps"],
                        "prefix_tokens": s["prefix_tokens"], "launches": launches}
    print(f"checkpoint check (c): infer_events on {videos[0].name} ({CKPT_VIDEO_FRAMES} frames "
          f"{CORPUS_HW[1]}x{CORPUS_HW[0]}, sampled to {cfg.num_frames}): wall {wall:.2f} s "
          f"(encode {s['encode_s']:.2f} s, prefill {s['prefill_s']:.3f} s, "
          f"{s['decode_steps']} steps {1e3 * s['decode_s'] / max(s['decode_steps'], 1):.2f} "
          f"ms/step), {s['prefix_tokens']} prefix tokens; events "
          f"{len(pred.timestamps)}; launches {launches}; plain versions on the card: "
          f"{plain or 'none'}", flush=True)
    idle = [r for r in CKPT_ROWS if launches[r] <= 0]
    if not isinstance(pred, EventPredictions) or idle or plain:
        fail(f"checkpoint (c): output {type(pred).__name__}, rows {idle} not launched, plain "
             f"versions {plain} on the card")
    check_head_slices(cfg.decoder, tokens)
    frames, ts = load_video_frames(str(videos[0]), cfg.num_frames)
    _, held = on_path(torch, "checkpoint request", lambda: pipe.infer_events_from_frames(
        frames, ts, CORPUS_ASK, max_new_tokens=CKPT_NEW))
    stats["on_path"] = held
    if not np.array_equal(pipe.last_stats["tokens"], tokens):
        fail("checkpoint (c): infer_events and infer_events_from_frames on the same frames "
             "gave other tokens")
    print(f"checkpoint check (c): infer_events_from_frames on load_video_frames' output gave "
          f"the same {tokens.shape[1]} tokens", flush=True)

    # (d) the serving CLI's entry over the videos and the broken file
    paths = [str(v) for v in videos] + [str(tmp / "broken.npy")]
    out = tmp / "serve.jsonl"
    result = serve(pipe, paths, str(out), frames=cfg.num_frames, max_new_tokens=CKPT_NEW)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    errors = [line for line in lines if "error" in line]
    stats["serve"] = result
    print(f"checkpoint check (d): serve over {len(paths)} files: {len(lines)} JSONL lines, "
          f"{len(errors)} error ({errors[0]['error'][:60] if errors else ''}); "
          f"{result['videos_per_s']:.4f} videos/s ({result['seconds']:.2f} s, {CKPT_NEW} new "
          "tokens, decode batch 32)", flush=True)
    if len(lines) != len(paths) or len(errors) != 1 or "broken" not in errors[0]["video"]:
        fail("checkpoint (d): serve did not write one line a video with the one error")
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"checkpoint: phase 7 took {stats['seconds']:.1f} s", flush=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


# Phase 8: the evaluation entry points (``trace_tpu_torch.eval``,
# ``runtime.inference``) at full width, in phase 7's directory: its TRACE-7B
# checkpoint and its .npy videos, four more of the kind beside them.
EVAL_VIDEOS = 8           # .npy videos of 256 640x360 frames: phase 7's 4 and 4 more
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


def eval_phase(torch, tmp: Path, native_decoder: str) -> tuple:
    """Phase 8, in phase 7's directory ``tmp``: (a) ``eval.evaluate.main`` for
    task tvg with the CLI's defaults (bf16, 128 frames, batch 4) over 8 .npy
    videos, a missing file, one with a corrupt header (.npy) and a junk .mp4;
    (b) ``model_init(quant="int8")``, ``run_vtg_eval`` for dvc streamed at
    batch 4, then ``score_results`` for dvc, dvc-anet and vhd; (c)
    ``run_mvbench`` on the frame-directory subtask with (b)'s pipeline; (d)
    ``runtime.inference.main`` on one .npy. Checks: a record per readable
    video and none else, the fmt file equal to the records; every score of
    the JAX package's keys and finite; in each run the path's rows launched
    (1, 2, 3; 1, 2, 3b, 4, 5; (d) 1, 2, 3), no plain version on the card,
    and each kernel, the first call at each shape, held to its plain
    version (check (e) of phase 5); accuracies in [0, 100] with no failure;
    (d)'s events finite. ``model_init`` gets ``SpmLikeTokenizer``: the
    checkpoint has no tokenizer files."""
    import gc
    import os

    import numpy as np
    from PIL import Image

    import trace_tpu_torch
    from trace_tpu_torch.eval import evaluate, mcqa
    from trace_tpu_torch.metrics import captioning, meteor_align
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime import inference
    from trace_tpu_torch.runtime import pipeline as pl
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    t_phase = time.perf_counter()
    ckpt = str(tmp / "trace-7b")
    stats = {"native_decoder": native_decoder}
    rng = np.random.default_rng(SEED + 8)
    for v in range(CKPT_VIDEOS, EVAL_VIDEOS):  # phase 7 wrote video0..3
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
          f"{getattr(meteor, 'approximate', False)}), stemmer {stats['stemmer']}; native video "
          f"decoder {native_decoder}; model_init takes SpmLikeTokenizer", flush=True)

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

        # (c) MVBench's frame-directory subtask with (b)'s pipeline
        root = tmp / "mvbench"
        frames_dir = root / "video" / mcqa.MVBENCH_TASKS["Episodic Reasoning"][1]
        base = rng.integers(0, 256, CORPUS_HW + (3,), dtype=np.uint8)
        for clip, n in EVAL_CLIPS:
            (frames_dir / clip).mkdir(parents=True)
            for i in range(1, n + 1):  # 00001.jpg ...: 3-fps dumps, 1-indexed
                Image.fromarray(np.roll(base, 8 * i, axis=1)).save(
                    frames_dir / clip / f"{i:05d}.jpg", quality=90)
        (root / "json").mkdir()
        (root / "json" / mcqa.MVBENCH_TASKS["Episodic Reasoning"][0]).write_text(json.dumps([
            {"video": clip, "question": q, "candidates": c, "answer": a,
             **({"start": b[0], "end": b[1]} if b else {})}
            for clip, q, c, a, b in EVAL_MCQA]))
        final, stats["c"] = run("c", "int8", lambda: mcqa.run_mvbench(
            pipe, str(root / "json"), str(root / "video"), num_frames=128,
            batch_size=EVAL_BATCH, max_new_tokens=EVAL_NEW,
            output_dir=str(root / "out"), tasks=["Episodic Reasoning"]))
        dump = json.loads((root / "out" / "test.json").read_text())
        stats["c"]["final"] = final
        print(f"eval check (c): run_mvbench {final}; {len(dump['res_list'])} answers",
              flush=True)
        accs = [v for k, v in final.items() if k != "num_failures"]
        if (final["num_failures"] != 0 or len(dump["res_list"]) != len(EVAL_MCQA)
                or set(final) != {"Episodic Reasoning", "Avg", "num_failures"}
                or not all(0.0 <= v <= 100.0 for v in accs)):
            fail("eval (c): run_mvbench failed an item or gave an accuracy outside [0, 100]")
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

    if sys.argv[1:] in (["--checkpoint"], ["--eval"]):
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_stats = checkpoint_phase(torch, Path(tmp))[1]
            if sys.argv[1:] == ["--eval"]:
                ckpt_stats["eval"] = eval_phase(torch, Path(tmp), ckpt_stats["native_decoder"])
            print(json.dumps(ckpt_stats), flush=True)
        return 0
    rows = kernel_checks(torch)
    if sys.argv[1:] == ["--kernels"]:
        print(json.dumps({name: {k: v for k, v in r.items()} for name, r in rows.items()}))
        return 0
    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's launches are those of the first path that runs it
    launches, stats, e2e = {}, [], {}
    modes = ("bf16", "int8", "int4p", "int4p_g0")
    for mode in modes:
        counts, mode_stats, e2e[mode] = end_to_end(torch, mode)
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)  # of the first path that runs the kernel
        stats += mode_stats
    corpus_launches, corpus = corpus_phase(torch)
    for name, n in corpus_launches.items():
        launches.setdefault(name, n)
    with tempfile.TemporaryDirectory() as tmp:  # the loops' metrics logs
        train_launches, train_stats, grad_check = training(torch, Path(tmp))
    for name, n in train_launches.items():
        launches.setdefault(name, n)
    with tempfile.TemporaryDirectory() as tmp:  # the checkpoint, videos, JSONL, eval files
        ckpt_launches, ckpt_stats = checkpoint_phase(torch, Path(tmp))
        eval_stats = eval_phase(torch, Path(tmp), ckpt_stats["native_decoder"])
    for name, n in ckpt_launches.items():
        if n:
            launches.setdefault(name, n)
    second = stats[1::2]  # the second request of each path
    per_step = lambda s: 1e3 * s["decode_s"] / max(s["decode_steps"], 1)
    col = lambda f: " | ".join(f(s) for s in second)
    print(f"second requests, {' | '.join(modes)} ({G0_LAYERS} layers): "
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
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches.get(name, 0),
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"],
         # the corpus phase's own count (pass A), beside the first path's
         "launches_corpus": corpus_launches.get(name, 0)}
        for name, r in rows.items()
    ]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        fail(f"no path launched {idle}")
    print(json.dumps({"requests": stats, "e2e": e2e, "corpus": corpus, "training": train_stats,
                      "gradient_check": grad_check, "checkpoint": ckpt_stats,
                      "eval": eval_stats, "card": card,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
