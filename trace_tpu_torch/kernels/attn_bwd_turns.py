"""The attention backward kernels (dq, dk/dv) timed beside other builds of
their source, on the card.

    python -m trace_tpu_torch.kernels.attn_bwd_turns [--dtype float32] [--head-dim 256]
        [--against NAME=PATH.cu ...]

Builds ``csrc/attention_bwd.cu`` (with ``--dtype float32``:
``csrc/attention_bwd_f32.cu``; with ``--head-dim 256``:
``csrc/attention_bwd_256.cu``) as it is (``this``) and each source named
by ``--against`` (say an earlier commit's copy, unpacked with ``git archive``
into a gitignored directory together with the ``*.cuh`` headers beside it),
loads each with ctypes, and times ``attn_bwd_dq_bf16`` and
``attn_bwd_dkv_bf16`` (``attn_bwd_dq_f32`` and ``attn_bwd_dkv_f32``) at the
shape of ``chip_smoke.py`` phase 3 (B = 2, 32 / 8 heads, T = 2048, hd 128,
causal, row 0 right-padded by 300 slots, do zero on padded rows; lse from
the forward kernel, delta from the pre-pass) and at the same shape with hd
64; with ``--head-dim 256`` at hd 256 and Falcon3-7B's 12 / 4 heads (the
width-256 source takes no other hd). CUDA events, median of 20 with the L2
flushed before each run; the
versions in turns, forward then backward (A B B A), so that a drift of the
card shows as a spread and not as a difference. Every version's gradients
are first held against the plain version (the limits of ``chip_smoke.py``,
in units of the largest |ref|: bf16 1e-2 + 2^-7 |ref| and ||diff|| / ||ref||
<= 1e-2; fp32 1e-5 + 1e-4 |ref| and 1e-4) and against a second run of
themselves, bit for bit; the script fails if ``this`` is outside the limits
or any version does not repeat itself (another version outside them is
reported and timed all the same: a variant built to measure its error).
Beside them: autograd's backward through SDPA with the same bias (the
smoke's library time; fp32 with TF32 off) and, in bf16, SDPA's flash
backend with ``is_causal=True`` and no bias. Each kernel's registers and
spills are printed as ptxas reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from trace_tpu_torch.kernels import flash_backward as fb
from trace_tpu_torch.kernels.build import CSRC
from trace_tpu_torch.kernels.decode_int8_turns import build, median_ms

B, T, PAD = 2, 2048, 300
HEADS = {64: (32, 8), 128: (32, 8), 256: (12, 4)}  # query / kv heads at each head dim
# per dtype: atol and rtol in units of the largest |ref|, ||diff|| / ||ref||
LIMITS = {"bfloat16": (1e-2, 2 ** -7, 1e-2), "float32": (1e-5, 1e-4, 1e-4)}
TF32_FLOPS_PER_S, FP32_FLOPS_PER_S, BF16_FLOPS_PER_S = 495e12, 67e12, 989e12


def inputs(g, hd, dtype):
    """q, k, v, bias, do, lse, delta at the phase-3 shape with head dim hd."""
    H, HKV = HEADS[hd]
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, k, v = randn(B, H, T, hd), randn(B, HKV, T, hd), randn(B, HKV, T, hd)
    real = torch.ones((B, T), dtype=torch.bool, device="cuda")
    real[0, T - PAD:] = False
    bias = torch.where(real, 0.0, -1e30).float()
    do = randn(B, H, T, hd) * real[:, None, :, None]
    o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=True)
    delta = fb.flash_attention_bwd_delta(o, do)
    return q, k, v, bias, do, lse, delta


def callers(lib, q, k, v, bias, do, lse, delta):
    """Functions that launch ``lib``'s dq and dk/dv kernels (the entries for
    q's dtype) once into fixed outputs."""
    H, HKV, hd = q.shape[1], k.shape[1], q.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    common = [t.data_ptr() for t in (q, k, v, bias, do, lse, delta)]
    tail = [B, H, H // HKV, T, T, hd, 1, float(hd ** -0.5), stream]

    def entry(name, outs):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (7 + len(outs)) + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        args = common + [t.data_ptr() for t in outs] + tail

        def run():
            err = fn(*args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err} at launch")
            return outs

        return run

    kind = "f32" if q.dtype == torch.float32 else "bf16"
    return {"dq": entry(f"attn_bwd_dq_{kind}", (dq,)),
            "dkv": entry(f"attn_bwd_dkv_{kind}", (dk, dv))}


def excess(got, want, atol, rtol) -> tuple[float, float]:
    """The largest excess over the limits and ||diff|| / ||ref||, in units of
    the largest |ref|, the worse of the outputs."""
    worst, rel = -1.0, 0.0
    for a, b in zip(got, want):
        unit = b.float().abs().max()
        a, b = a.float() / unit, b.float() / unit
        diff = (a - b).abs()
        worst = max(worst, (diff - atol - rtol * b.abs()).max().item())
        rel = max(rel, (diff.norm() / b.norm()).item())
    return worst, rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(LIMITS), default="bfloat16")
    ap.add_argument("--head-dim", type=int, choices=(64, 128, 256), action="append",
                    help="head dims to time (default 128 and 64; 256 alone, bf16)")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH.cu")
    args = ap.parse_args()
    head_dims = args.head_dim or [128, 64]
    wide = 256 in head_dims
    if wide and (len(set(head_dims)) > 1 or args.dtype != "bfloat16"):
        ap.error("--head-dim 256 times the width-256 source alone, in bf16")
    if not torch.cuda.is_available():
        print("attn_bwd_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    atol, rtol, rel_norm = LIMITS[args.dtype]
    sources = {"this": CSRC / ("attention_bwd_f32.cu" if f32 else
                               "attention_bwd_256.cu" if wide else "attention_bwd.cu")}
    for item in args.against:
        name, _, path = item.partition("=")
        sources[name] = Path(path)
    libs = build(sources, "attn_bwd_turns", ptxas=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for hd in head_dims:
        q, k, v, bias, do, lse, delta = inputs(g, hd, dtype)
        H = HEADS[hd][0]
        want = {"dq": (fb.flash_attention_bwd_dq(q, k, v, bias, do, lse, delta, causal=True,
                                                 impl="plain"),),
                "dkv": fb.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta, causal=True,
                                                  impl="plain")}
        visible = sum((T - p) * (T - p + 1) // 2 for p in (PAD, 0))
        product = 2 * H * hd * visible
        causal_mask = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
        lib_mask = torch.where(causal_mask[None, None], bias[:, None, None, :],
                               torch.tensor(-1e30, device="cuda")).to(dtype)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask, enable_gqa=True)
        sdpa = median_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), flush)
        if f32:  # three TF32 products for each product; the CUDA cores' fp32 beside
            bounds = (f"three TF32 products at 495 TFLOP/s: dq "
                      f"{9 * product / TF32_FLOPS_PER_S * 1e3:.4f} ms, dk/dv "
                      f"{12 * product / TF32_FLOPS_PER_S * 1e3:.4f} ms; at the 67 TFLOP/s fp32 "
                      f"CUDA-core peak dq {3 * product / FP32_FLOPS_PER_S * 1e3:.4f} ms, dk/dv "
                      f"{4 * product / FP32_FLOPS_PER_S * 1e3:.4f} ms")
            flash = ""
        else:
            bounds = (f"dq {3 * product / BF16_FLOPS_PER_S * 1e3:.4f} ms, dk/dv "
                      f"{4 * product / BF16_FLOPS_PER_S * 1e3:.4f} ms (operations, 989 TFLOP/s)")
            flash = (f"; SDPA flash backward, is_causal, no bias "
                     f"{median_ms(flash_sdpa_backward(q, k, v, do), flush):.4f} ms")
        print(f"hd = {hd}: one product over the visible pairs {product / 1e9:.1f} GFLOP; bounds "
              f"{bounds}; SDPA backward with the bias {sdpa:.4f} ms{flash}", flush=True)
        del leaves, out, lib_mask
        runs = {name: callers(lib, q, k, v, bias, do, lse, delta) for name, lib in libs.items()}
        for name, kernels in runs.items():
            for which, run in kernels.items():
                got = tuple(x.clone() for x in run())
                again = run()
                torch.cuda.synchronize()
                over, rel = excess(got, want[which], atol, rtol)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                inside = over <= 0 and rel <= rel_norm
                print(f"  {name} {which}: excess {over:.6g}, ||diff|| / ||ref|| {rel:.6g}, "
                      f"repeat bit-equal {same}{'' if inside else ' (outside the limits)'}",
                      flush=True)
                if not same or (name == "this" and not inside):
                    print(f"attn_bwd_turns: {name} {which} disagrees with the plain version "
                          f"or with itself", flush=True)
                    return 1
        for which in ("dq", "dkv"):
            times = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                times[name].append(median_ms(runs[name][which], flush))
            for name, ts in times.items():
                print(f"  {which} {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
        del q, k, v, bias, do, lse, delta, want, runs
    return 0


def flash_sdpa_backward(q, k, v, do):
    """A function that runs autograd's backward through SDPA's flash backend
    with is_causal and no bias once, what PyTorch's own backward reaches on
    this shape (another function than the kernels', which take the padding
    bias)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


if __name__ == "__main__":
    sys.exit(main())
