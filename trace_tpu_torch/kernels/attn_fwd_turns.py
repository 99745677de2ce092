"""The attention forward kernel (rows 1, 2 and 8) beside other builds of its
source, on the card: bit for bit at query offset 0, and timed in turns.

    python -m trace_tpu_torch.kernels.attn_fwd_turns [--against NAME=PATH.cu ...]

Builds ``csrc/attention.cu`` as it is (``this``) and each source named by
``--against`` (an earlier commit's copy, unpacked with ``git archive`` into a
gitignored directory with the ``*.cuh`` headers beside it; a source from
before the query offset takes the older entry point without it), loads each
with ctypes, and runs ``attn_fwd_bf16`` at the shapes of ``chip_smoke.py``
phase 3: row 1 (q [2, 32, 2048, 128], k / v [2, 8, 2048, 128], causal, row 0
left-padded by 300: the main launch and the launch for rows that see no
key), row 8 (the same, right-padded, with the lse) and row 2 (the ViT chunk,
column slices of a fused [16, 592, 3072], tq 577). Every version's outputs
are held bit for bit to this build's, then timed in turns (A B B A; CUDA
events, median of 20, L2 flushed). Each kernel's registers and spills, and
those of the fp32 forms (``attention_f32.cu``, ``attention_bwd_f32.cu``,
``quant_matmul_f32.cu``; the decode kernels' fp32 instances:
``decode_bf16_turns --f32``, ``decode_int8_turns --f32``), are printed as
ptxas reports them.
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


def caller(lib, offset_abi: bool, q, k, v, bias, o, lse, *, group, tq, tk, kv_len, causal,
           strides):
    """A function that launches ``lib``'s forward once into ``o`` (and
    ``lse``); ``offset_abi``: the entry point takes the query offset (0)."""
    fn = lib.attn_fwd_bf16
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
            raise RuntimeError(f"attn_fwd_bf16: CUDA error {err} at launch")
        return (o, lse) if lse is not None else (o,)

    return run


def cases(g):
    """name -> (operands, launch arguments) at the phase-3 shapes."""
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
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
    o = torch.empty((B, P, D), dtype=torch.bfloat16, device="cuda")
    hd = D // NH
    bht = lambda x: (x.stride(0), hd, x.stride(1))
    out["row 2"] = ((vq, vk, vv, None, o, None), dict(
        group=1, tq=P, tk=P, kv_len=TQ, causal=False,
        strides={"H": NH, "hd": hd, "q": bht(vq), "k": bht(vk), "v": bht(vv), "o": bht(o),
                 "bias": 0}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_fwd_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sources = {"this": CSRC / "attention.cu"}
    for item in args.against:
        name, _, path = item.partition("=")
        sources[name] = Path(path)
    libs = build(sources, "attn_fwd_turns", ptxas=True)
    build({Path(s).stem: CSRC / s for s in F32_SOURCES}, "attn_fwd_turns_f32", ptxas=True)
    offset_abi = {name: "q_offset" in src.read_text() for name, src in sources.items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for case, ((q, k, v, bias, o, lse), kw) in cases(g).items():
        runs, outs = {}, {}
        for name, lib in libs.items():
            # each version writes its own outputs
            mine = (torch.empty_like(o), torch.empty_like(lse) if lse is not None else None)
            runs[name] = caller(lib, offset_abi[name], q, k, v, bias, *mine, **kw)
            outs[name] = tuple(x.clone() for x in runs[name]())
        torch.cuda.synchronize()
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
