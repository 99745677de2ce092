"""The attention forward kernel (rows 1, 2 and 8) beside other builds of its
source, on the card, timed in turns.

    python -m trace_tpu_torch.kernels.attn_fwd_turns [--dtype float32] [--against NAME=PATH.cu ...]

Builds ``csrc/attention.cu`` (with ``--dtype float32``:
``csrc/attention_f32.cu``) as it is (``this``) and each source named by
``--against`` (an earlier commit's copy, unpacked with ``git archive`` into a
gitignored directory with the ``*.cuh`` headers beside it; a bf16 source from
before the query offset takes the older entry point without it), loads each
with ctypes, and runs ``attn_fwd_bf16`` (``attn_fwd_f32``) at the shapes of
``chip_smoke.py`` phase 3: row 1 (q [2, 32, 2048, 128], k / v [2, 8, 2048,
128], causal, row 0 left-padded by 300: the main launch and the launch for
rows that see no key), row 8 (the same, right-padded, with the lse) and row
2 (the ViT chunk, column slices of a fused [16, 592, 3072], tq 577). In
bf16 every version's outputs are held bit for bit to this build's. In fp32,
where a new design changes the arithmetic, every version is held to the
plain version within the fp32 limits of ``chip_smoke.py`` (|diff| <= 1e-4 +
1e-4 |ref|, ||diff|| / ||ref|| <= 1e-4, the lse within 1e-4) and to a second
run of itself bit for bit; the script fails if ``this`` is outside the limits
or does not repeat itself (another version that does not hold them is
reported and timed all the same: a variant built to measure where the time
goes); the bounds (three TF32 products at 495 TFLOP/s, and the 67 TFLOP/s
CUDA-core peak) and SDPA fp32's time are printed beside. Then the versions
are timed in turns (A B B A; CUDA events, median of 20, L2 flushed). Each
kernel's registers and spills are printed as ptxas reports them, in bf16
also those of the fp32 sources (``attention_f32.cu``,
``attention_bwd_f32.cu``, ``quant_matmul_f32.cu``; the decode kernels' fp32
instances: ``decode_bf16_turns --f32``, ``decode_int8_turns --f32``).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from trace_tpu_torch.kernels.build import CSRC
from trace_tpu_torch.kernels.decode_int8_turns import build, median_ms

F32_SOURCES = ("attention_f32.cu", "attention_bwd_f32.cu", "quant_matmul_f32.cu")
TF32_FLOPS_PER_S, FP32_FLOPS_PER_S = 495e12, 67e12
ATOL, RTOL, REL_NORM, LSE_TOL = 1e-4, 1e-4, 1e-4, 1e-4  # the fp32 limits of chip_smoke.py


def caller(lib, offset_abi: bool, q, k, v, bias, o, lse, *, group, tq, tk, kv_len, causal,
           strides):
    """A function that launches ``lib``'s forward (the entry for q's dtype)
    once into ``o`` (and ``lse``); ``offset_abi``: the entry point takes the
    query offset (0)."""
    fn = lib.attn_fwd_f32 if q.dtype == torch.float32 else lib.attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * (8 + offset_abi) + [ctypes.c_float]
                   + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    B, H, hd = q.shape[0], strides["H"], strides["hd"]
    ints = [B, H, group, tq, tk, hd, kv_len, int(causal)] + [0] * offset_abi
    args = ([q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None, o.data_ptr(),
             lse.data_ptr() if lse is not None else None] + ints + [float(hd ** -0.5)]
            + list(strides["q"]) + list(strides["k"]) + list(strides["v"]) + list(strides["o"])
            + [strides["bias"], torch.cuda.current_stream().cuda_stream])

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"attn_fwd: CUDA error {err} at launch")
        return (o, lse) if lse is not None else (o,)

    return run


def cases(g, dtype=torch.bfloat16):
    """name -> (operands, launch arguments) at the phase-3 shapes."""
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    B, H, HKV, T, HD, PAD = 2, 32, 8, 2048, 128, 300
    q, k, v = randn(B, H, T, HD), randn(B, HKV, T, HD), randn(B, HKV, T, HD)
    left = torch.zeros((B, T), device="cuda")
    left[0, :PAD] = -1e30
    right = torch.zeros((B, T), device="cuda")
    right[0, T - PAD:] = -1e30
    four = lambda x: x.stride()[:3]
    out = {}
    for name, bias, lse in (("row 1", left, None),
                            ("row 8", right, torch.empty((B, H, T), device="cuda"))):
        o = torch.empty_like(q)
        out[name] = ((q, k, v, bias, o, lse), dict(
            group=H // HKV, tq=T, tk=T, kv_len=T, causal=True,
            strides={"H": H, "hd": HD, "q": four(q), "k": four(k), "v": four(v), "o": four(o),
                     "bias": T}))
    B, P, D, NH, TQ = 16, 592, 1024, 16, 577
    qkv = randn(B, P, 3 * D)
    vq, vk, vv = qkv.split(D, dim=-1)
    o = torch.empty((B, P, D), dtype=dtype, device="cuda")
    hd = D // NH
    bht = lambda x: (x.stride(0), hd, x.stride(1))
    out["row 2"] = ((vq, vk, vv, None, o, None), dict(
        group=1, tq=P, tk=P, kv_len=TQ, causal=False,
        strides={"H": NH, "hd": hd, "q": bht(vq), "k": bht(vk), "v": bht(vv), "o": bht(o),
                 "bias": 0}))
    return out


def plain(case, q, k, v, bias, kw):
    """The plain version's outputs of a case (o, and the lse for row 8)."""
    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd

    if case == "row 2":
        return (vit_attention_btd(q, k, v, kw["kv_len"], kw["strides"]["H"], impl="plain"),)
    if case == "row 8":
        o, lse = fb.flash_attention_fwd_res(q, k, v, bias, causal=True, impl="plain")
        return o, lse.reshape(lse.shape[:3])
    return (flash_attention(q, k, v, bias, True, impl="plain"),)


def yardstick(case, q, k, v, bias, kw):
    """SDPA in q's dtype on the case's function (the smoke's library call),
    and the operations of one product over the visible pairs."""
    import torch.nn.functional as F

    if case == "row 2":
        B, P, D = q.shape
        NH, TQ = kw["strides"]["H"], kw["kv_len"]
        heads = lambda x: x.view(B, P, NH, D // NH).transpose(1, 2)
        key_mask = (torch.arange(P, device="cuda") < TQ)[None, None, None, :]
        return (lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                       attn_mask=key_mask),
                2 * B * NH * TQ * TQ * (D // NH))
    B, H, T, HD = q.shape
    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    mask = torch.where(causal[None, None], bias[:, None, None, :],
                       torch.tensor(-1e30, device="cuda"))
    pads = (bias < -1e29).sum(dim=1).tolist()
    visible = sum((T - p) * (T - p + 1) // 2 for p in pads)
    return (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True),
            2 * H * HD * visible)


def held(case, got, want, kw) -> tuple[float, float, float]:
    """The largest excess over |diff| <= ATOL + RTOL |ref|, ||diff|| /
    ||ref|| (on the rows that count) and the lse's largest difference."""
    o, ref = got[0].float(), want[0].float()
    if case == "row 2":
        o, ref = o[:, :kw["kv_len"]], ref[:, :kw["kv_len"]]
    diff = (o - ref).abs()
    lse_err = (got[1] - want[1]).abs().max().item() if len(got) > 1 else 0.0
    return ((diff - ATOL - RTOL * ref.abs()).max().item(),
            (diff.norm() / ref.norm()).item(), lse_err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_fwd_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    f32 = args.dtype == "float32"
    sources = {"this": CSRC / ("attention_f32.cu" if f32 else "attention.cu")}
    for item in args.against:
        name, _, path = item.partition("=")
        sources[name] = Path(path)
    libs = build(sources, "attn_fwd_turns", ptxas=True)
    if not f32:
        build({Path(s).stem: CSRC / s for s in F32_SOURCES}, "attn_fwd_turns_f32", ptxas=True)
    offset_abi = {name: f32 or "q_offset" in src.read_text() for name, src in sources.items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for case, ((q, k, v, bias, o, lse), kw) in cases(g, getattr(torch, args.dtype)).items():
        runs, outs = {}, {}
        for name, lib in libs.items():
            # each version writes its own outputs
            mine = (torch.empty_like(o), torch.empty_like(lse) if lse is not None else None)
            runs[name] = caller(lib, offset_abi[name], q, k, v, bias, *mine, **kw)
            outs[name] = tuple(x.clone() for x in runs[name]())
        torch.cuda.synchronize()
        if f32:
            want = plain(case, q, k, v, bias, kw)
            lib_fn, product = yardstick(case, q, k, v, bias, kw)
            print(f"  {case}: one product over the visible pairs {product / 1e9:.1f} GFLOP; "
                  f"bound by three TF32 products at 495 TFLOP/s "
                  f"{6 * product / TF32_FLOPS_PER_S * 1e3:.4f} ms, at the 67 TFLOP/s fp32 "
                  f"CUDA-core peak {2 * product / FP32_FLOPS_PER_S * 1e3:.4f} ms; SDPA fp32 "
                  f"{median_ms(lib_fn, flush):.4f} ms", flush=True)
            for name, got in outs.items():
                over, rel, lse_err = held(case, got, want, kw)
                same = all(torch.equal(a, b) for a, b in zip(got, runs[name]()))
                inside = over <= 0 and rel <= REL_NORM and lse_err <= LSE_TOL
                print(f"  {case} {name}: excess {over:.6g}, ||diff|| / ||ref|| {rel:.6g}, lse "
                      f"{lse_err:.3g}, repeat bit-equal {same}"
                      f"{'' if inside else ' (outside the limits)'}", flush=True)
                if name == "this" and not (same and inside):
                    print(f"attn_fwd_turns: {case}: {name} disagrees with the plain version "
                          f"or with itself", flush=True)
                    return 1
        else:
            for name, got in outs.items():
                same = all(torch.equal(a, b) for a, b in zip(got, outs["this"]))
                print(f"  {case} {name}: bit-equal to this build's {same}", flush=True)
                if not same:
                    print(f"attn_fwd_turns: {case}: {name} differs from this build", flush=True)
                    return 1
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(median_ms(runs[name], flush))
        for name, ts in times.items():
            print(f"  {case} {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
