"""The int8 decode attention kernel timed beside other builds of its source,
on the card.

    python -m trace_tpu_torch.kernels.decode_int8_turns [--against NAME=PATH.cu ...]
        [--group G] [--kv-heads N] [--head-dim HD] [--f32]

Builds ``csrc/decode_attention_int8.cu`` as it is (``this``) and each source
named by ``--against`` (say an earlier commit's copy, unpacked with
``git archive`` into a gitignored directory), loads each with ctypes, and
times both modes at the shapes of ``chip_smoke.py`` phase 3: an int8 cache
stripe quantized from random K/V, 8 kv heads, G = 4, hd 128, S = 2304,
half the slots masked at random, at B = 4 and at B = 32 (the bench's decode
batch), and at B = 32 with serving-shaped masks (left padding, a visible
prefix, masked future slots). ``--group`` and ``--kv-heads`` set G and the kv
heads (qwen2-7B: ``--group 7 --kv-heads 4``), ``--head-dim`` hd (any the
wrapper takes; a source that does not take it fails at launch); ptxas's
registers and spills
of every kernel of the source are printed. ``--f32`` times the fp32 entries
(``decode_attn_int8_f32_*``: an fp32 query, fp32 out) instead, with the fp32
rows' limits and SDPA in fp32. CUDA events, median of 20 with the L2 flushed
before each run; the versions in turns, forward then backward (A B B A), so
that a drift of the card shows as a spread and not as a difference. Every
version's output is held against the plain version first (the limits of
``chip_smoke.py``), and whether it equals this build's bit for bit is
printed; SDPA on the dequantized stripe is timed beside them as the
yardstick. A source with an older interface gets its workspaces from the
script, allocated once, outside the timed calls: the four-launch one (it
exports ``decode_attn_int8_chunk``) three, the one-block-a-pair fp32 source
(``decode_attention_f32.cu``, which has no bf16 entry) its [B, H, S] scores.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from trace_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc
from trace_tpu_torch.kernels.decode_attention import _PLAIN_INT8, INT8_MODES, _source

NKV, G, S, HD = 8, 4, 2304, 128
CASES = ((4, "random"), (32, "random"), (32, "serving"))
ATOL, RTOL = 2e-3, 2 ** -7
# the fp32 forms' limits in chip_smoke.py (dequant rounds p to bf16 as its
# plain version does: the bf16 row's atol)
F32_ATOL = {"bf16": 1e-4, "s8dot": 1e-4, "dequant": 2e-3}
F32_RTOL = 1e-4


def limits(kernel: str, f32: bool) -> tuple:
    """(atol, rtol) of a decode form: kernel "bf16" (the bf16 or fp32 cache),
    "s8dot" or "dequant"; its fp32 instance with ``f32``."""
    return (F32_ATOL[kernel], F32_RTOL) if f32 else (ATOL, RTOL)


def report(tag, name, got, ref, first, limit) -> bool:
    """Print ``got``'s largest error against the plain version's ``ref`` and
    whether it equals the first version's output bit for bit; False where it
    passes the limits (atol, rtol)."""
    diff = (got.float() - ref).abs()
    excess = (diff - limit[0] - limit[1] * ref.abs()).max().item()
    print(f"  {tag}{name}: max_abs_err {diff.max().item():.6g}, excess {excess:.6g}, "
          f"bit-equal to {first[0]}: {torch.equal(got, first[1])}", flush=True)
    return excess <= 0


def build(sources: dict[str, Path], subdir: str = "decode_int8_turns",
          ptxas: bool = False) -> dict[str, ctypes.CDLL]:
    """Each source compiled on its own (all nvcc processes together) into
    ``_build/<subdir>/<name>.so`` and loaded; with ``ptxas``, each kernel's
    registers and spills as ptxas reports them are printed."""
    out = BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if ptxas else []
    procs = {name: subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, *extra, "-o", str(out / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if ptxas:
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def caller(lib, mode, q, stripe, bias):
    """A function that launches ``lib``'s kernel once into a fixed output
    (the fp32 entry for an fp32 q)."""
    B, NKV = stripe["kq"].shape[:2]
    G, hd = q.shape[1] // NKV, q.shape[-1]
    o = torch.empty_like(q)
    f32 = q.dtype == torch.float32
    fn = getattr(lib, f"decode_attn_int8_f32_{mode}" if f32 else f"decode_attn_int8_{mode}")
    fn.restype = ctypes.c_int
    args = [q.data_ptr(), *(stripe[n].data_ptr() for n in ("kq", "ks", "vq", "vs")),
            bias.data_ptr(), o.data_ptr()]
    ws = []
    if f32 and not hasattr(lib, "decode_attn_int8_s8dot"):  # the scratch interface
        ws = [torch.empty((B, NKV * G, S), dtype=torch.float32, device="cuda")]
        args += [ws[0].data_ptr()]
    elif hasattr(lib, "decode_attn_int8_chunk"):  # the four-launch interface
        lib.decode_attn_int8_chunk.restype = ctypes.c_int
        lib.decode_attn_int8_chunk.argtypes = []
        nchunk = -(-S // lib.decode_attn_int8_chunk())
        ws = [torch.empty(shape, dtype=dtype, device="cuda") for shape, dtype in (
            ((B, NKV, G, S), torch.float32), ((B, NKV, G, 2), torch.float32),
            ((B, NKV, nchunk, G, hd), torch.int32))]
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


def median_ms(fn, flush, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mask_bias(g, B, mask="random", S=S):
    """[B, S] fp32 bias (0 visible, -1e30 masked): half the slots at random;
    serving-shaped: row b sees slots [pad, end), its padded prompt, then no
    future slot; or a first decode step after a prefill into the cache:
    slots [pad, S)."""
    if mask == "random":
        visible = torch.rand((B, S), generator=g, device="cuda") < 0.5
    else:
        pad = torch.randint(0, S // 8, (B, 1), generator=g, device="cuda")
        end = (torch.randint(S // 2, S, (B, 1), generator=g, device="cuda")
               if mask == "serving" else S)
        slot = torch.arange(S, device="cuda")[None]
        visible = (slot >= pad) & (slot < end)
    return torch.where(visible, 0.0, -1e30).float()


def inputs(g, B, mask="random", nkv=NKV, group=G, dtype=torch.bfloat16, hd=HD):
    """q [B, nkv * group, 1, hd] in ``dtype``, an int8 stripe and its bias."""
    from trace_tpu_torch.model.mistral import _quantize_kv

    stripe = {}
    for vals, scales in (("kq", "ks"), ("vq", "vs")):
        x = torch.randn((B, nkv, S, hd), generator=g, device="cuda").to(torch.bfloat16)
        stripe[vals], stripe[scales] = (t.contiguous() for t in _quantize_kv(x))
    q = torch.randn((B, nkv * group, 1, hd), generator=g, device="cuda").to(dtype)
    return q, stripe, mask_bias(g, B, mask)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH.cu")
    ap.add_argument("--group", type=int, default=G, help="query rows a kv head (1 ... 8)")
    ap.add_argument("--kv-heads", type=int, default=NKV)
    ap.add_argument("--head-dim", type=int, default=HD)
    ap.add_argument("--f32", action="store_true", help="the fp32 entries: fp32 q and out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_int8_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    # this build's library of the head dim: the source, or its *_pad.cu,
    # *_256.cu or *_256_pad.cu twin
    sources = {"this": CSRC / _source("decode_attention_int8.cu", args.head_dim)}
    for item in args.against:
        name, _, path = item.partition("=")
        sources[name] = Path(path)
    libs = build(sources, ptxas=True)
    nkv, dtype, hd = args.kv_heads, torch.float32 if args.f32 else torch.bfloat16, args.head_dim
    print(f"{nkv} kv heads, G = {args.group}, hd {hd}, q {dtype}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for B, mask in CASES:
        q, stripe, bias = inputs(g, B, mask, nkv, args.group, dtype, hd)
        kd = stripe["kq"].to(dtype) * stripe["ks"].transpose(-1, -2).to(dtype)
        vd = stripe["vq"].to(dtype) * stripe["vs"].transpose(-1, -2).to(dtype)
        attn_mask = bias[:, None, None, :].to(dtype)
        sdpa = median_ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=attn_mask, enable_gqa=True), flush)
        visible = int((bias == 0).sum().item())
        nbytes = (2 * q.numel() * q.element_size() + 2 * visible * nkv * (hd + 2)
                  + bias.numel() * 4)
        print(f"B = {B}, {mask} mask: SDPA {sdpa:.4f} ms; byte bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms", flush=True)
        for mode in INT8_MODES:
            ref = _PLAIN_INT8[mode](q, stripe["kq"], stripe["ks"], stripe["vq"], stripe["vs"],
                                    bias).float()
            runs = {name: caller(lib, mode, q, stripe, bias) for name, lib in libs.items()}
            first = None
            for name, run in runs.items():
                got = run().clone()
                torch.cuda.synchronize()
                first = first or (name, got)
                if not report(f"{mode} ", name, got, ref, first, limits(mode, args.f32)):
                    print(f"decode_int8_turns: {name} disagrees with the plain version",
                          flush=True)
                    return 1
            times = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                times[name].append(median_ms(runs[name], flush))
            for name, ts in times.items():
                print(f"  {mode} {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms", flush=True)
        del q, stripe, bias, kd, vd, attn_mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
