#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from csrc/ (nvcc, parallel);
  3. each kernel against its plain PyTorch version at serving shapes, bf16,
     with its time (CUDA events, median of 20, L2 flushed between runs), the
     plain version's time, the time of one PyTorch library call computing
     the same function (a yardstick only, never called by the port) and the
     least time the card could take (the larger of bytes / 3.35 TB/s and
     FLOPs / 989 TFLOP/s, the H100 SXM data-sheet rates);
  4. the bf16 TRACE-7B serving path end to end at full width (CLIP
     ViT-L/14-336 at the -2 tap, spatial_slot, Mistral-7B, random weights
     from seed 0): two requests of 2 synthetic 128-frame 336x336 videos,
     64 new tokens each, launch counts checked per request, outputs checked
     against the same path with every attention kernel replaced by its plain
     version.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it prints no result and exits 2.
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
KERNEL_TOL = {  # name: (atol, rtol)
    "flash_attention": (3e-2, 2 ** -7),
    "vit_attention_btd": (8e-3, 2 ** -7),
    "decode_attention": (2e-3, 2 ** -7),
}
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


def compare(name: str, out, ref) -> dict:
    """Kernel output against the plain version's, on the rows that count:
    the largest difference, the largest excess over atol + rtol |ref|
    (> 0 fails), ||diff|| / ||ref|| and the RMS of ref."""
    atol, rtol = KERNEL_TOL[name]
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    return {"err": diff.max().item(),
            "excess": (diff - atol - rtol * ref.abs()).max().item(),
            "rel_norm": (diff.norm() / ref.norm()).item(),
            "ref_rms": ref.square().mean().sqrt().item()}


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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
    del q, ck, cv, out, ref

    for name, r in rows.items():
        atol, rtol = KERNEL_TOL[name]
        print(f"kernel {name}: max_abs_err={r['err']:.6f} (|diff| <= {atol} + "
              f"{rtol} |ref|, excess {r['excess']:.6f}) rel_norm_err="
              f"{r['rel_norm']:.6f} (tol {REL_NORM_TOL}) ref_rms={r['ref_rms']:.4f} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"sdpa_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]})", flush=True)
        if not (r["excess"] <= 0 and r["rel_norm"] <= REL_NORM_TOL):
            fail(f"{name}: kernel disagrees with its plain version")
    return rows


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


def end_to_end(torch):
    """Phase 4: the serving path at full width, two requests."""
    import numpy as np

    from trace_tpu_torch import EventPredictions
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.mistral import compute_logits
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    cfg = TraceConfig()
    t0 = time.perf_counter()
    params = init_trace_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"init: random bf16 TRACE-7B weights in {time.perf_counter() - t0:.1f} s",
          flush=True)
    tok = SpmLikeTokenizer()
    pipe = TracePipeline(params, cfg, tok)
    rng = np.random.default_rng(SEED)
    videos = [rng.integers(0, 256, (FRAMES, 336, 336, 3), dtype=np.uint8)
              for _ in range(VIDEOS)]
    stamps = [[[float(i)] for i in range(FRAMES)]] * VIDEOS
    asks = ["Localize the visual events in the video and describe each one.",
            "Find every moment where something changes, with timestamps."]
    kernels = (flash_attention, vit_attention_btd, decode_attention)
    vit_layers = cfg.vision.num_layers + 1 + cfg.vision.select_layer
    chunks = VIDEOS * FRAMES // cfg.vit_chunk_size

    launches, stats = None, []
    for request in (1, 2):
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        preds = pipe.infer_events_batch(videos, stamps, asks, max_new_tokens=MAX_NEW)
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in kernels}
        s = pipe.last_stats
        want = {"vit_attention_btd": vit_layers * chunks,
                "flash_attention": cfg.decoder.num_layers,
                "decode_attention": cfg.decoder.num_layers * s["decode_steps"]}
        print(f"request {request}: launches {counts} expected {want}; "
              f"{s['prefix_tokens']} prefix tokens, {s['decode_steps']} decode steps; "
              f"wall {wall:.3f} s, encode {s['encode_s']:.3f} s "
              f"({VIDEOS * FRAMES / s['encode_s']:.1f} ViT frames/s), "
              f"prefill {s['prefill_s']:.3f} s, decode "
              f"{1e3 * s['decode_s'] / max(s['decode_steps'], 1):.2f} ms/step", flush=True)
        if counts != want or min(counts.values()) <= 0:
            fail(f"launch counts {counts} != expected {want}")
        if not all(isinstance(p, EventPredictions) for p in preds):
            fail("output does not parse into EventPredictions")
        check_head_slices(cfg.decoder, s["tokens"])
        launches = launches or counts
        stats.append({k: v for k, v in s.items() if k != "tokens"} | {"wall_s": wall})
    tokens = pipe.last_stats["tokens"]

    # The same path with every attention kernel replaced by its plain
    # version, and an fp32 reference of the same model (plain attention,
    # fp32 weights and activations). With random weights the bf16 model is
    # ill-conditioned (the connector's N(0, 1) slots make its softmax over
    # 576 patches nearly an argmax; 32 random decoder layers amplify), so
    # kernel-vs-plain has no fixed scale; the test is that the kernel path
    # is no further from the fp32 reference than the plain bf16 path is,
    # within REF_RATIO_TOL.
    plain = TracePipeline(params, cfg, tok, attn_impl="plain")
    f32 = lambda t: {k: f32(v) if isinstance(v, dict) else v.float() for k, v in t.items()}
    ref = TracePipeline(f32(params), dataclasses.replace(cfg, dtype=torch.float32),
                        tok, attn_impl="plain")
    prefix, mask = pipe.encode_prefix(videos, stamps, asks)
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
        state = gen._prefill(p._decoder_params, cfg.decoder, x, pm,
                             cache_len=bucket + 1, impl=impl)
        logits[name] = compute_logits(p._decoder_params, state[2])
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
        print(f"{what} (||diff|| / ||ref||): kernel vs plain {e['kernel_vs_plain']:.5f}, "
              f"kernel vs fp32 {e['kernel_vs_fp32']:.5f}, plain vs fp32 "
              f"{e['plain_vs_fp32']:.5f} (tol: kernel vs fp32 <= {REF_RATIO_TOL} x "
              f"plain vs fp32)", flush=True)
    print(f"greedy tokens of the kernel path equal the plain path's for the first "
          f"{agree} of {MAX_NEW} per row", flush=True)
    for what, e in errs.items():
        if not e["kernel_vs_fp32"] <= REF_RATIO_TOL * e["plain_vs_fp32"]:
            fail(f"{what}: the kernel path is further from the fp32 reference "
                 "than the plain path")
    return launches, stats, {**errs, "greedy_agree": agree,
                             "decode_step": step_profile}


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
    launches, stats, e2e = end_to_end(torch)

    sources = {
        "flash_attention": ("trace_tpu_torch/kernels/csrc/attention.cu",
                            "trace_tpu/kernels/flash_attention.py:112"),
        "vit_attention_btd": ("trace_tpu_torch/kernels/csrc/attention.cu",
                              "trace_tpu/kernels/flash_attention.py:209"),
        "decode_attention": ("trace_tpu_torch/kernels/csrc/decode_attention.cu",
                             "trace_tpu/kernels/decode_attention.py:288"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]
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
