#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from csrc/ (nvcc, parallel);
  3. each kernel against its plain PyTorch version at serving shapes (the
     three bf16 attention kernels; the int8 weight product, 2-D and
     stacked; int8 decode attention in both modes; the nibble-packed int4
     weight products, per channel and grouped, each in its split-K form at
     M = 2 and its tensor-core form at M = 3886), with its time (CUDA
     events, median of 20, L2 flushed between runs), the plain version's
     time, the time of one PyTorch library call computing the same function
     (a yardstick only, never called by the port) and the least time the
     card could take (the larger of bytes / 3.35 TB/s and operations over
     the peak rate of their type, 989 TFLOP/s bf16 or 1979 TOP/s int8, the
     H100 SXM data-sheet rates);
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
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it prints no result and exits 2. ``--kernels`` stops
after phase 3 (a short check of freshly edited kernels; no last line).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
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
# output to bf16 and the probabilities to bf16 before P.V (at other points
# of the online softmax), so they differ by about one bf16 step of the
# output: rtol is two steps (2^-7). Each atol is about twice the largest
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
# form adds each 16 products into the fp32 accumulator inside mma.sync, which
# truncates where an fp32 add rounds to nearest; over K / 16 <= 896 steps the
# sum drifts by up to ~K / 16 x 2^-24 of the largest partial sum, so 1e-4 of
# the largest output (a dropped k step or a misplaced nibble moves outputs by
# 1e-2 and more); bf16 outputs two bf16 steps relative as above.
KERNEL_TOL = {  # name: (atol, rtol)
    "flash_attention": (3e-2, 2 ** -7),
    "vit_attention_btd": (8e-3, 2 ** -7),
    "decode_attention": (2e-3, 2 ** -7),
    "quant_matmul": (1e-5, 1e-5),           # fp32 out, in units of max |ref|
    "quant_matmul_stacked": (1e-5, 2 ** -7),  # bf16 and fp32 outs, same units
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

    quant_matmul_checks(torch, g, rows)
    int8_decode_checks(torch, g, rows)
    packed_int4_checks(torch, g, rows)

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


def merge(parts: list) -> dict:
    """One row out of several timed shapes: errors at their worst, times and
    bounds summed (the row then stands for the shapes together)."""
    worst = {k: max(p[k] for p in parts) for k in ("err", "excess", "rel_norm")}
    total = {k: sum(p[k] for p in parts) for k in ("ms", "plain_ms", "library_ms")}
    by = max(parts, key=lambda p: p["bound"][0])["bound"][1]
    return {**worst, **total, "ref_rms": parts[0]["ref_rms"],
            "bound": (sum(p["bound"][0] for p in parts), by)}


def quant_matmul_checks(torch, g, rows: dict) -> None:
    """The int8 weight product against its plain version: the 2-D entry on
    the lm_head at M = 2 (timed) and at a ragged shape; the stacked entry at
    M = 2, layer 17 of 32, on the four weights of a fused decoder layer (the
    row is their sum: one layer's weight products of a decode step)."""
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
              f"{r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})",
              flush=True)
        return r

    x = torch.randn((2, 4096), generator=g, device="cuda").to(torch.bfloat16)
    q, s = weight(4096, 32000)
    head = one("quant_matmul", lambda impl: quant_matmul(
        x, q, s, out_dtype=torch.float32, impl=impl), x, q, s)
    xr = torch.randn((37, 1000), generator=g, device="cuda").to(torch.bfloat16)
    qr, sr = weight(1000, 1100)
    ragged = one("quant_matmul", lambda impl: quant_matmul(
        xr, qr, sr, out_dtype=torch.float32, impl=impl), xr, qr, sr, timed=False)
    head.update({k: max(head[k], ragged[k]) for k in ("err", "excess", "rel_norm")})
    rows["quant_matmul"] = head
    del q, s, qr, sr

    L, LI, parts = 32, 17, []
    for K, N, out_dtype in ((4096, 6144, torch.bfloat16), (4096, 4096, torch.bfloat16),
                            (4096, 28672, torch.float32), (14336, 4096, torch.bfloat16)):
        xk = torch.randn((2, K), generator=g, device="cuda").to(torch.bfloat16)
        q, s = weight(L, K, N)
        parts.append(one("quant_matmul_stacked", lambda impl: quant_matmul_stacked(
            xk, q, s, LI, out_dtype=out_dtype, impl=impl), xk, q[LI], s[LI]))
        del q, s
    rows["quant_matmul_stacked"] = merge(parts)


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
            del qp, s
    # ragged M, N (and, per channel, K / 2 no multiple of 8), untimed
    for grouped, M, K, N in ((False, 3, 1000, 1100), (False, 37, 1000, 1100),
                             (True, 3, 1024, 1100), (True, 37, 1024, 1100)):
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
    quantized from random K/V as the decoder quantizes it."""
    import torch.nn.functional as F

    from trace_tpu_torch.kernels.decode_attention import INT8_MODES, decode_attention
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.model.mistral import _quantize_kv, init_kv_cache

    B, H, NKV, S, HD, LI = 4, 32, 8, 2304, 128, 17
    cfg = DecoderConfig(kv_cache_dtype="int8")
    cache = init_kv_cache(cfg, B, S, device="cuda")
    stripe = {name: leaf[LI] for name, leaf in cache.items()}
    for vals, scales in (("kq", "ks"), ("vq", "vs")):
        x = torch.randn((B, NKV, S, HD), generator=g, device="cuda").to(torch.bfloat16)
        stripe[vals][:], stripe[scales][:] = _quantize_kv(x)
    q = torch.randn((B, H, 1, HD), generator=g, device="cuda").to(torch.bfloat16)
    bias = torch.where(torch.rand((B, S), generator=g, device="cuda") < 0.5,
                       0.0, -1e30).float()
    # the yardstick's operands: the stripe dequantized to bf16 beforehand
    kd = stripe["kq"].to(torch.bfloat16) * stripe["ks"].transpose(-1, -2)
    vd = stripe["vq"].to(torch.bfloat16) * stripe["vs"].transpose(-1, -2)
    lib_mask = bias[:, None, None, :].to(torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=lib_mask,
                                                 enable_gqa=True)
    # as for the bf16 row, the visible slots' K and V rows (1 byte a value)
    # and their two scales; both products count as int8 operations
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
            fail(f"{name}: non-finite output")
        rows[name] = dict(
            **compare(name, out, ref), ms=median_ms(torch, run),
            plain_ms=median_ms(torch, lambda: run("plain")),
            library_ms=median_ms(torch, lib),
            bound=bound(nbytes, ops, INT8_OPS_PER_S if mode == "s8dot" else BF16_FLOPS_PER_S))


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


def end_to_end(torch, mode: str):
    """Phase 4: the serving path at full width, two requests, in the bf16
    (``mode="bf16"``), the int8 (``"int8"``) or the int4p serving
    configuration with group-128 scales (``"int4p"``); ``"int4p_g0"`` is the
    int4p configuration with per-channel scales at a depth of G0_LAYERS."""
    import numpy as np

    from trace_tpu_torch import EventPredictions
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.kernels.quant_matmul import (
        quant_matmul,
        quant_matmul_p4,
        quant_matmul_p4_grouped,
        quant_matmul_stacked,
    )
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

    def reset():
        for fn in (flash_attention, vit_attention_btd, decode_attention,
                   quant_matmul, quant_matmul_stacked, quant_matmul_p4,
                   quant_matmul_p4_grouped):
            fn.launches = 0
        for m in decode_attention.launches_int8:
            decode_attention.launches_int8[m] = 0
        for fn in (quant_matmul_p4, quant_matmul_p4_grouped):
            fn.launches_by_form.update(splitk=0, mma=0)

    def counts():
        return {"flash_attention": flash_attention.launches,
                "vit_attention_btd": vit_attention_btd.launches,
                "decode_attention": decode_attention.launches,
                "quant_matmul": quant_matmul.launches,
                "quant_matmul_stacked": quant_matmul_stacked.launches,
                **{f"decode_attention_int8_{m}": n
                   for m, n in decode_attention.launches_int8.items()},
                "quant_matmul_p4": quant_matmul_p4.launches_by_form["splitk"],
                "quant_matmul_p4_mma": quant_matmul_p4.launches_by_form["mma"],
                "quant_matmul_p4_grouped": quant_matmul_p4_grouped.launches_by_form["splitk"],
                "quant_matmul_p4_grouped_mma": quant_matmul_p4_grouped.launches_by_form["mma"]}

    launches, stats = None, []
    for request in (1, 2):
        reset()
        t0 = time.perf_counter()
        preds = pipe.infer_events_batch(videos, stamps, asks, max_new_tokens=MAX_NEW)
        wall = time.perf_counter() - t0
        got = counts()
        s = pipe.last_stats
        steps = s["decode_steps"]
        # what the code implies: one ViT attention per layer and chunk, one
        # flash attention per decoder layer (prefill), one decode attention
        # per layer and step; quantized: four weight products per layer and
        # step (wqkv, wo, w_gateup, w_down) through the tree's kernel (int8
        # stacked; packed int4 per channel or grouped, split-K form) and one
        # 2-D int8 product per lm_head call (the prefill's last position, then
        # every step). The prefill is W8A8 / W4A8 (no kernel of these) except
        # on group-scaled int4p leaves: four tensor-core-form products a layer
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
        prefill = lambda: gen._prefill(p._decoder_params, p.config.decoder, x, pm,
                                       cache_len=bucket + 1, impl=impl)
        if name == "kernel":
            state, prefill_profile = device_profile(torch, f"{mode} prefill", prefill)
        else:
            state = prefill()
        logits[name] = compute_logits(p._decoder_params, state[2], impl=impl)
        if name == "kernel":
            step_profile = profile_decode_step(torch, pipe, cfg.decoder, state)
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


def device_profile(torch, label: str, fn, top: int = 8):
    """Run fn once under torch.profiler; print the device-busy time and the
    CUDA kernels that take most of it. Returns (fn's result, summary)."""
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
    return out, {"traced_wall_ms": wall, "device_busy_ms": busy, "device_events": events,
                 "top": [[name[:80], ms, n] for name, (ms, n) in ranked]}


def profile_decode_step(torch, pipe, dec, state) -> dict:
    """One decode step of the kernel path (decoder, combined logits, argmax)
    from a prefilled cache: its wall time (median of 5, synchronised), and
    under torch.profiler the CUDA kernels it launches and the share of the
    step's wall time (profiled, so the host side is slowed) in which the
    device runs one."""
    from torch.profiler import ProfilerActivity, profile

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
    print(f"decode step (B={last.shape[0]}): {out['wall_ms']:.2f} ms wall; traced: "
          f"{out['device_events']} device events, busy {busy:.2f} ms of "
          f"{out['traced_wall_ms']:.2f} ms", flush=True)
    return out


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
    }
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches.get(name, 0),
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        fail(f"the serving paths never launched {idle}")
    print(json.dumps({"requests": stats, "e2e": e2e, "card": card,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
