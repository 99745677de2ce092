"""The bf16 decode attention kernel timed beside other builds of its source,
on the card.

    python -m trace_tpu_torch.kernels.decode_bf16_turns [--against NAME=PATH.cu ...]
        [--group G] [--kv-heads N] [--head-dim HD] [--f32]

Builds ``csrc/decode_attention.cu`` as it is (``this``) and each source
named by ``--against`` (say an earlier commit's copy, unpacked with
``git archive`` into a gitignored directory), loads each with ctypes, and
times it at the shapes of ``chip_smoke.py`` phase 3: a bf16 cache stripe of
random K/V, 8 kv heads, G = 4, hd 128, S = 2304, half the slots masked at
random, at B = 4 and at B = 32 (the bench's decode batch), and at B = 32
with serving-shaped masks (left padding, a visible prefix, masked future
slots); last at the shape of the decode step that ``chip_smoke.py`` profiles
(B = 2, S = 2049: a prefill of 2048 slots, left padding, then the new
slot). ``--group`` and ``--kv-heads`` set G and the kv heads (qwen2-7B:
``--group 7 --kv-heads 4``), ``--head-dim`` hd (any the wrapper takes; a
source that does not take it fails at launch); ptxas's registers and spills
of every kernel of the source are printed. ``--f32`` times the fp32 entry (``decode_attn_f32``:
fp32 q, cache and out) on an fp32 stripe instead, with the fp32 row's
limits and SDPA in fp32. CUDA events, median of 20 with the L2 flushed
before each run; the versions in turns, forward then backward (A B B A), so
that a drift of the card shows as a spread and not as a difference. Every
version's output is held against the plain version first (the limits of
``chip_smoke.py``), and whether it equals this build's bit for bit is
printed; SDPA on the same stripe is timed beside them as the yardstick. A
source with an older interface gets its workspaces from the script,
allocated once, outside the timed calls: the two-launch one (it exports
``decode_attn_chunk``) two, the one-block-a-pair fp32 source
(``decode_attention_f32.cu``, which has no bf16 entry) its [B, H, S] scores.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from trace_tpu_torch.kernels.build import CSRC
from trace_tpu_torch.kernels.decode_attention import _source, decode_attention_bf16
from trace_tpu_torch.kernels.decode_int8_turns import (
    CASES,
    HD,
    NKV,
    G,
    S,
    build,
    limits,
    mask_bias,
    median_ms,
    report,
)

# B, S, mask; last the smoke's profiled decode step
SHAPES = tuple((B, S, mask) for B, mask in CASES) + ((2, 2049, "step"),)


def caller(lib, q, k, v, bias):
    """A function that launches ``lib``'s kernel once into a fixed output
    (the fp32 entry for fp32 operands)."""
    B, S = bias.shape
    NKV, hd = k.shape[1], k.shape[-1]
    G = q.shape[1] // NKV
    o = torch.empty_like(q)
    f32 = q.dtype == torch.float32
    fn = lib.decode_attn_f32 if f32 else lib.decode_attn_bf16
    fn.restype = ctypes.c_int
    args = [t.data_ptr() for t in (q, k, v, bias, o)]
    ws = []
    if f32 and not hasattr(lib, "decode_attn_bf16"):  # the scratch interface
        ws = [torch.empty((B, NKV * G, S), dtype=torch.float32, device="cuda")]
        args += [ws[0].data_ptr()]
    elif hasattr(lib, "decode_attn_chunk"):  # the two-launch interface
        lib.decode_attn_chunk.restype = ctypes.c_int
        lib.decode_attn_chunk.argtypes = []
        nchunk = -(-S // lib.decode_attn_chunk())
        ws = [torch.empty((B, NKV, nchunk, G, n), dtype=torch.float32, device="cuda")
              for n in (2, hd)]
        args += [w.data_ptr() for w in ws]
    fn.argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*args, B, NKV, G, S, hd, float(hd ** -0.5), stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        return o

    run.workspaces = ws  # alive as long as the caller
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH.cu")
    ap.add_argument("--group", type=int, default=G, help="query rows a kv head (1 ... 8)")
    ap.add_argument("--kv-heads", type=int, default=NKV)
    ap.add_argument("--head-dim", type=int, default=HD)
    ap.add_argument("--f32", action="store_true", help="the fp32 entry: fp32 q, cache and out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_bf16_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    # this build's library of the head dim: the source, or its *_pad.cu,
    # *_256.cu or *_256_pad.cu twin
    sources = {"this": CSRC / _source("decode_attention.cu", args.head_dim)}
    for item in args.against:
        name, _, path = item.partition("=")
        sources[name] = Path(path)
    libs = build(sources, "decode_bf16_turns", ptxas=True)
    nkv, group, hd = args.kv_heads, args.group, args.head_dim
    dtype = torch.float32 if args.f32 else torch.bfloat16
    print(f"{nkv} kv heads, G = {group}, hd {hd}, {dtype}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for B, S, mask in SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, nkv * group, 1, hd), (B, nkv, S, hd), (B, nkv, S, hd)))
        bias = mask_bias(g, B, mask, S)
        attn_mask = bias[:, None, None, :].to(dtype)
        sdpa = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, enable_gqa=True), flush)
        visible = int((bias == 0).sum().item())
        nbytes = (2 * q.numel() + 2 * visible * nkv * hd) * q.element_size() + bias.numel() * 4
        print(f"B = {B}, S = {S}, {mask} mask: SDPA {sdpa:.4f} ms; byte bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms", flush=True)
        ref = decode_attention_bf16(q, k, v, bias).float()
        runs = {name: caller(lib, q, k, v, bias) for name, lib in libs.items()}
        first = None
        for name, run in runs.items():
            got = run().clone()
            torch.cuda.synchronize()
            first = first or (name, got)
            if not report("", name, got, ref, first, limits("bf16", args.f32)):
                print(f"decode_bf16_turns: {name} disagrees with the plain version", flush=True)
                return 1
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(median_ms(runs[name], flush))
        for name, ts in times.items():
            print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
        del q, k, v, bias, attn_mask, runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
