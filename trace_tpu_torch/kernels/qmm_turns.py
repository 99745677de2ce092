"""The decode-step weight products (int8, packed int4 per channel and
grouped, at up to 8 rows of x, and the int8 products at 32) timed beside
other builds of their sources, on the card.

    python -m trace_tpu_torch.kernels.qmm_turns [--against NAME=PATH ...]

Builds ``csrc/quant_matmul.cu`` and ``csrc/quant_matmul_p4.cu`` as they are
(``this``) and the two sources of each directory named by ``--against`` (or
of the directory of a ``.cu`` file named there: say an earlier commit's
``csrc/``, unpacked with ``git archive`` into a gitignored directory with
its ``*.cuh`` headers), loads each with ctypes, and times the 2-D entries at
the shapes of ``chip_smoke.py`` phase 3: the four weights of a fused 7B
layer (``wqkv`` 4096x6144, ``wo`` 4096x4096, ``w_gateup`` 4096x28672 with an
fp32 output, ``w_down`` 14336x4096) at M = 2 (rows 5, 6 and 7 of PERF.md)
and M = 8, the ``lm_head`` (4096x32000, fp32 output, row 4) at M = 2, and
the int8 layer and ``lm_head`` at M = 32, the bench's decode batch: a source
with the wide tile (it exports ``quant_matmul_wide_clusters_at_once``) runs
it there, an older one tiles of 8 rows, each re-reading the weight, with
the plan it had. A source with the older interface (it exports
``quant_matmul_kchunk_max``) gets its workspace from the script, allocated
once, outside the timed calls. CUDA events, median of 20 with the L2
flushed before each run; the versions in turns, forward then backward
(A B B A), so that a drift of the card shows as a spread and not as a
difference. Every version is first held against the plain version (the
limits of ``chip_smoke.py``: 1e-5 of the largest output, plus 2^-7
relative for a bf16 output) and against a second run of itself, bit for
bit. Beside the times: the byte bound (3.35 TB/s), ``torch.matmul`` on the
weight dequantized to bf16 beforehand, each version's time with the L2
flushed by a read of 256 MB instead of a write (so that the cache holds no
dirty lines to write back while the product reads: the write flush of
``chip_smoke.py`` adds up to 50 MB of write-back to every timed call), each
product's device time as ``torch.profiler`` reads it (the kernels alone,
without the launch), and ptxas's registers and spills of each kernel.

Last, where the time of this tree's int8 product goes: it is built again
with its k-steps cut out (``stream``: what is left is the copies, the
ring's barriers and counters and the epilogue), with each ``mma`` cut out
but its operands kept (``no_mma``: the copies, the shared-memory reads of
weight and x and the conversions stay) and with the int8 form's reads of x
(lds32, or ldmatrix in the wide tile) replaced by constants (``no_x``);
the outputs of all three are meaningless. All four are timed,
read-flushed, at K = 4096, M = 2 and N = 16896, 28672 and 33792 (132, 224
and 264 strips of 128 columns: the busiest SM takes two blocks of the plan
at every N, of 256, 512 and 512 KB), and in the wide form at M = 32 and N =
28672 (``w_gateup``: 8 KB of x beside each 16 KB of weight).

Each version's output is also compared with this tree's, bit for bit
(``bit-equal to this``), so that a build of the parent's sources shows
whether a change left the bf16 instances' arithmetic as it was.

With ``--f32`` it times the fp32 forms instead. First the split form (M <=
8): this tree's fp32 instances of ``qmm_split.cuh`` (the ``_f32`` entries of
``quant_matmul.cu`` and ``quant_matmul_p4.cu``), or, in a source that has
none, the older workspace form of ``quant_matmul_f32.cu`` (a split-K launch
into partial sums the script allocates, and a finish launch), at M =
1, 2 and 8 on the four layer shapes (int8, packed per channel, grouped with
group-128 scales) and the int8 ``lm_head``; each build held to the plain
version (1e-5 of the largest output and a relative norm of 1e-4, 2^-7
relative for a bf16 output) and to a second run of itself, then timed in
turns (A B B A, median of 20, L2 flushed) beside the byte bound, the
two-TF32-product bound (495 TFLOP/s) and ``torch.matmul`` of fp32 x with
the dequantized fp32 weight (TF32 off). Then where this tree's time goes,
at M = 2 and 8 on the four layer shapes: its split form built again with
the k-steps cut out (``stream``), each ``mma`` cut out with its operands
kept (``no_mma``), the weight's conversions (lop3, fadd) cut out
(``no_convert``; the grouped form's scale multiply stays), with two
products a k-step at M <= 4 as beyond (``unfolded``: x_hi and x_lo not
sharing one B fragment) and the packed forms' ring as 8 stages of 64
packed rows in place of 4 of 128 (``rows64``); the last two give right
results. Then the tensor-core form
(``csrc/quant_matmul_f32.cu``, M > 8): int8, packed per channel and
grouped at x [3886, K] fp32 over the four layer shapes, each build held to
the plain version (1e-5 of the largest output, relative norm 1e-4), to a
second run of itself and to this tree's bits, then timed in turns (A B B
A, median of 5, L2 flushed) beside ``torch.matmul`` of fp32 x with the
dequantized fp32 weight (TF32 off), with ptxas's registers and spills;
last, this tree's error at ``w_down`` (K = 14336) against an fp64 product,
with the wgmma sum promoted every 128 values of k (the kernel's) and only
at the end (a build of the source with ``PROMOTE_K = 0``), beside the plain
fp32 version's.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from trace_tpu_torch.kernels import quant_matmul as qmm
from trace_tpu_torch.kernels.build import BUILD_DIR, CSRC
from trace_tpu_torch.kernels.decode_int8_turns import build, median_ms
from trace_tpu_torch.model.quantize import dequantize, unpack4

LAYER = ((4096, 6144, torch.bfloat16), (4096, 4096, torch.bfloat16),
         (4096, 28672, torch.float32), (14336, 4096, torch.bfloat16))
LM_HEAD = ((4096, 32000, torch.float32),)
CASES = (  # label, form, M, shapes
    ("row 5, int8 layer", "i8", 2, LAYER), ("row 6, p4 layer", "p4", 2, LAYER),
    ("row 7, p4g layer", "p4g", 2, LAYER), ("row 4, int8 lm_head", "i8", 2, LM_HEAD),
    ("int8 layer", "i8", 8, LAYER), ("p4 layer", "p4", 8, LAYER),
    ("p4g layer", "p4g", 8, LAYER),
    ("row 5 at the bench's decode batch, int8 layer", "i8", 32, LAYER),
    ("row 4 at the bench's decode batch, int8 lm_head", "i8", 32, LM_HEAD))
ENTRY = {"i8": ("i8", "quant_matmul_i8"), "p4": ("p4", "quant_matmul_p4_bf16"),
         "p4g": ("p4", "quant_matmul_p4_grouped_bf16")}
ATOL, HBM = 1e-5, 3.35e12
_KSTEP = "      kstep(d, ws, xs, t, slot, r0, kk, sg0);"  # the consumers' work on a k-step
_MMA = '  asm("mma.sync.aligned.m16n8k16'  # the tensor-core product, in mma()
_XLOAD = ("b0[n] = lds32(xrow + n * 8 * 128 + ((chunk ^ g) << 4));",  # int8 B fragments
          "b1[n] = lds32(xrow + n * 8 * 128 + (((chunk + 1) ^ g) << 4));")
_XLDSM = "ldsm_x4(xb + row * 128 + (((chunk + mq % 2) ^ r) << 4), b0[2 * q], b1[2 * q],"
BREAKDOWN = {
    "full": (),
    "stream": ((_KSTEP, "      (void)kk;"),),
    # the operands stay live and nothing is computed from them
    "no_mma": ((_MMA, '  asm volatile("" :: "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));'
                      "\n  if (0) " + _MMA.lstrip()),),
    "no_x": tuple((load, load[:5] + " = 0x3f803f80u + n;") for load in _XLOAD) + (
        (_XLDSM, "b0[2 * q] = b1[2 * q] = b0[2 * q + 1] = b1[2 * q + 1] = 0x3f803f80u + q;\n"
                 "          if (0) " + _XLDSM),),
}
BREAKDOWN_MN = ((2, 16896), (2, 28672), (2, 33792), (32, 28672))


def old_kchunk(M, K, N, strip, kmax):
    """The workspace interface's K chunk, as its wrapper chose it."""
    blocks = -(-N // strip) * -(-M // 4)
    ksplit = max(-(-(4 * 132) // blocks), -(-K // kmax))
    ksplit = max(min(ksplit, -(-K // 64)), -(-K // kmax))
    return -(-K // ksplit)


def caller(lib, form, x, w, s, out_dtype):
    """A function that launches ``lib``'s entry for ``form`` once into a
    fixed output (the int8 product's wide entry at M > 8 where ``lib`` has
    one)."""
    M, K = x.shape
    N = w.shape[1]
    wide = (form == "i8" and M > qmm.SPLIT_ROWS
            and hasattr(lib, "quant_matmul_wide_clusters_at_once"))
    fn = getattr(lib, ENTRY[form][1] + "_wide" * wide)
    fn.restype = ctypes.c_int
    y = torch.empty((M, N), dtype=out_dtype, device="cuda")
    ws = []
    if hasattr(lib, "quant_matmul_clusters_at_once") or hasattr(
            lib, "quant_matmul_p4_clusters_at_once"):
        if wide:
            ask, lead = lib.quant_matmul_wide_clusters_at_once, ()
        elif form == "i8":
            ask, lead = lib.quant_matmul_clusters_at_once, ()
        else:
            ask, lead = lib.quant_matmul_p4_clusters_at_once, (int(form == "p4g"),)
        ask.restype = ctypes.c_int
        fit = [0] + [ask(*lead, c) for c in range(1, qmm.SPLIT_MAX_CLUSTER + 1)]
        plan = qmm.split_plan(M, K, N, "i8w" if wide else form, fit.__getitem__)
        tail = [M, K, N, plan.cluster, plan.share]
        how = f"{plan.blocks} blocks of {plan.tile} rows, clusters of {plan.cluster}"
    else:  # the workspace interface
        packed = form != "i8"
        const = (lib.quant_matmul_p4_strip, lib.quant_matmul_p4_kchunk_max) if packed else (
            lib.quant_matmul_strip, lib.quant_matmul_kchunk_max)
        for c in const:
            c.restype = ctypes.c_int
        rows = K // 2 if packed else K
        kchunk = old_kchunk(M, rows, N, const[0](), const[1]())
        ws = [torch.empty((-(-rows // kchunk), M, N), dtype=torch.float32, device="cuda")]
        tail = [ws[0].data_ptr(), M, K, N, kchunk]
        how = f"K chunks of {kchunk} + a finish launch"
    args = [x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), *tail,
            int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream]
    pointers = 4 + len(ws)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * (len(args) - pointers - 1)
                   + [ctypes.c_void_p])

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{ENTRY[form][1]}: CUDA error {err} at launch")
        return y

    run.workspaces, run.how = ws, how  # alive as long as the caller
    return run


def operands(g, form, M, K, N):
    """x, the weight bytes, the scale, the plain version and the weight
    dequantized to bf16 (the yardstick's operand)."""
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    if form == "i8":
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        s = (torch.rand((N,), generator=g, device="cuda") * 4e-4 + 1e-4).to(torch.bfloat16)
        return x, w, s, qmm.quant_matmul_plain, (w.to(torch.bfloat16) * s).contiguous()
    w = torch.randint(-128, 128, (K // 2, N), generator=g, device="cuda", dtype=torch.int8)
    G = K // 128 if form == "p4g" else 1
    s = (torch.rand((G, N), generator=g, device="cuda") * 4e-3 + 1e-3).to(torch.bfloat16)
    dense = dequantize({"qp": w, "s": s})
    if form == "p4":
        return x, w, s.reshape(-1), qmm.quant_matmul_p4_plain, dense
    return x, w, s, qmm.quant_matmul_p4_grouped_plain, dense


def read_flushed_ms(fn, flush, reps: int = 20) -> float:
    """Median CUDA-event time of fn, the L2 flushed before each run by a
    read of the 256 MB buffer (clean lines only)."""
    words = flush.view(torch.float32)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.amax(words)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def breakdown_libs() -> dict[str, ctypes.CDLL]:
    """This tree's quant_matmul.cu as it is and with its k-steps cut out,
    each built beside its own copy of the headers."""
    out = BUILD_DIR / "qmm_turns" / "breakdown"
    sources = {}
    for name, edits in BREAKDOWN.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in [*CSRC.glob("*.cuh"), CSRC / "quant_matmul.cu"]:
            shutil.copy(f, d)
        text = (d / "qmm_split.cuh").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: qmm_split.cuh no longer has one {old.strip()!r}")
            text = text.replace(old, new)
        (d / "qmm_split.cuh").write_text(text)
        sources[name] = d / "quant_matmul.cu"
    return build(sources, "qmm_turns/breakdown_libs")


def device_ms(fn, flush, names: tuple, reps: int = 20) -> float:
    """The mean time per call of the kernels whose names hold one of
    ``names``, read by torch.profiler over reps calls (L2 flushed before
    each)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in names))
    return us / 1e3 / reps


F32_M = 3886                 # the smoke's prefill rows
PROMOTE = "PROMOTE_K = 128;"  # the fp32 tensor-core form's promotion interval
F32_FLOPS, TF32_FLOPS = 67e12, 495e12  # H100 SXM: CUDA-core fp32, dense TF32


def f32_operands(g, form, M, K, N):
    """fp32 x, the weight bytes, the scale, the groups and the dense fp32
    weight ``W`` with y = (x @ W) (* s for the int8 and per-channel forms)."""
    x = torch.randn((M, K), generator=g, device="cuda")
    if form == "i8":
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        s = (torch.rand((N,), generator=g, device="cuda") * 4e-4 + 1e-4).to(torch.bfloat16)
        return x, w, s, 1, w.float()
    w = torch.randint(-128, 128, (K // 2, N), generator=g, device="cuda", dtype=torch.int8)
    G = K // 128 if form == "p4g" else 1
    s = (torch.rand((G, N), generator=g, device="cuda") * 4e-3 + 1e-3).to(torch.bfloat16)
    nibbles = unpack4(w).float()
    if form == "p4":
        return x, w, s.reshape(-1), 1, nibbles
    # each weight times its group's scale in fp32: exact (dequantize rounds it to bf16)
    return x, w, s, G, (nibbles.reshape(G, K // G, N) * s.float()[:, None]).reshape(K, N)


_F32_CODE = {"i8": 0, "p4": 1, "p4g": 2}  # quant_matmul_f32.cu's form codes


def f32_caller(lib, form, x, w, s, groups, y):
    """A function that launches ``lib``'s fp32 tensor-core entry once into y
    (``quant_matmul_f32_tiled``, or an older source's ``quant_matmul_f32``
    with its workspace arguments unused at M > 8)."""
    M, K = x.shape
    N = y.shape[1]
    out_f32, stream = int(y.dtype == torch.float32), torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "quant_matmul_f32_tiled"):
        fn = lib.quant_matmul_f32_tiled
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        args = [x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N,
                _F32_CODE[form], groups, out_f32, stream]
    else:
        fn = lib.quant_matmul_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        rows = K if form == "i8" else K // 2
        args = [x.data_ptr(), w.data_ptr(), s.data_ptr(), None, y.data_ptr(), M, K, N,
                _F32_CODE[form], groups, 1, rows, out_f32, stream]
    fn.restype = ctypes.c_int

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"fp32 tensor-core form {form}: CUDA error {err} at launch")
        return y

    return run


def old_f32_splits(M, rows, N):
    """(splits, chunk) of an older quant_matmul_f32.cu's workspace form as
    its wrapper chose them: about 264 blocks of 256 columns, each split at
    least 64 rows."""
    strips = -(-N // 256)
    splits = max(1, min(-(-264 // strips), -(-rows // 64)))
    chunk = -(-rows // splits)
    return -(-rows // chunk), chunk


_F32_SPLIT_ENTRY = {"i8": "quant_matmul_i8_f32", "p4": "quant_matmul_p4_f32",
                    "p4g": "quant_matmul_p4_grouped_f32"}


def f32_split_caller(libs, form, x, w, s, groups, y):
    """A function that launches one build's fp32 split form once into y:
    ``libs`` are its (quant_matmul, quant_matmul_p4, quant_matmul_f32)
    libraries; the fp32 instance of the split form where the build has one,
    else the workspace form (its partial sums allocated here, once)."""
    i8, p4, f32 = libs
    M, K = x.shape
    N = y.shape[1]
    out_f32, stream = int(y.dtype == torch.float32), torch.cuda.current_stream().cuda_stream
    ws = []
    if hasattr(i8, "quant_matmul_i8_f32"):
        lib = i8 if form == "i8" else p4
        ask, lead = ((lib.quant_matmul_f32_clusters_at_once, ()) if form == "i8" else
                     (lib.quant_matmul_p4_f32_clusters_at_once, (int(form == "p4g"),)))
        ask.restype = ctypes.c_int
        fit = [0] + [ask(*lead, c) for c in range(1, qmm.SPLIT_MAX_CLUSTER + 1)]
        plan = qmm.split_plan(M, K, N, form + "f", fit.__getitem__)
        fn = getattr(lib, _F32_SPLIT_ENTRY[form])
        extra = [groups] if form == "p4g" else []
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * len(extra) + [ctypes.c_void_p]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        args = [x.data_ptr(), w.data_ptr(), s.data_ptr(), *extra, y.data_ptr(), M, K, N,
                plan.cluster, plan.share, out_f32, stream]
        how = f"{plan.blocks} blocks, clusters of {plan.cluster}"
    else:
        fn = f32.quant_matmul_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        splits, chunk = old_f32_splits(M, K if form == "i8" else K // 2, N)
        ws = [torch.empty((splits, M, N), dtype=torch.float32, device="cuda")]
        args = [x.data_ptr(), w.data_ptr(), s.data_ptr(), ws[0].data_ptr(), y.data_ptr(), M, K,
                N, _F32_CODE[form], groups, splits, chunk, out_f32, stream]
        how = f"{splits} splits of {chunk} rows + a finish launch"
    fn.restype = ctypes.c_int

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"fp32 split form {form}: CUDA error {err} at launch")
        return y

    run.workspaces, run.how = ws, how
    return run


F32_SPLIT_M = (1, 2, 8)
F32_SPLIT_CASES = (("row 5 fp32, int8 layer", "i8", LAYER), ("row 6 fp32, p4 layer", "p4", LAYER),
                   ("row 7 fp32, p4g layer", "p4g", LAYER),
                   ("row 4 fp32, int8 lm_head", "i8", LM_HEAD))
_MMA_TF32 = '  asm("mma.sync.aligned.m16n8k8'  # the TF32 product, in mma_tf32()
F32_BREAKDOWN = {
    "full": (),
    "stream": (("      kstep(d, ws, xs, t, slot, r0, kk, sg0);", "      (void)kk;"),),
    "no_mma": ((_MMA_TF32, '  asm volatile("" :: "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), '
                           '"r"(b1));\n  if (0) ' + _MMA_TF32.lstrip()),),
    "no_convert": (("  return __uint_as_float((w & mask) | one) - base;",
                    "  return __uint_as_float(w);"),),
    "unfolded": (("if (p.M <= 4)  // half the products", "if (p.M < 0)  // unfolded"),),
    "rows64": (("  static constexpr int ROWS = 128; ",
                "  static constexpr int ROWS = F32 && PACKED ? 64 : 128; "),
               ("(F32 && PACKED ? 4 : 5)", "(F32 && PACKED ? 8 : 5)")),
}
_F32_PLAIN = {"i8": qmm.quant_matmul_plain, "p4": qmm.quant_matmul_p4_plain,
              "p4g": qmm.quant_matmul_p4_grouped_plain}


def f32_split_check(name, run, form, ref, M, K, N, out_dtype) -> tuple:
    """(the output, an error line or None): the plain version's limits and a
    second run's bits."""
    got = run().clone()
    again = run()
    torch.cuda.synchronize()
    unit = ref.abs().max()
    rtol = 2 ** -7 if out_dtype == torch.bfloat16 else 0.0
    excess = ((got.float() - ref).abs() / unit - ATOL - rtol * ref.abs() / unit).max().item()
    rel = ((got.float() - ref).norm() / ref.norm()).item()
    if excess > 0 or (out_dtype == torch.float32 and rel > 1e-4) or not torch.equal(got, again):
        return got, (f"qmm_turns: {name} fp32 {form} M = {M} {K}x{N} disagrees with the plain "
                     f"version (excess {excess:.3e}, relative norm {rel:.3e}) or with itself")
    return got, None


def f32_split_turns(dirs: dict, flush, g) -> int:
    """The fp32 split form of each build in turns, then where this tree's
    time goes (see the module's docstring)."""
    sources = {f"{name}_{src}": d / f"{src}.cu" for name, d in dirs.items()
               for src in ("quant_matmul", "quant_matmul_p4", "quant_matmul_f32")}
    built = build(sources, "qmm_turns/f32_split", ptxas=True)
    libs = {name: tuple(built[f"{name}_{src}"] for src in
                        ("quant_matmul", "quant_matmul_p4", "quant_matmul_f32")) for name in dirs}
    for M in F32_SPLIT_M:
        for label, form, shapes in F32_SPLIT_CASES:
            total = {name: [0.0, 0.0] for name in libs}
            lib_ms = bound_ms = ceil_ms = 0.0
            for K, N, out_dtype in shapes:
                x, w, s, groups, dense = f32_operands(g, form, M, K, N)
                ref = _F32_PLAIN[form](x, w, s, out_dtype).float()
                runs, outs = {}, {}
                for name, lb in libs.items():
                    y = torch.empty((M, N), dtype=out_dtype, device="cuda")
                    runs[name] = f32_split_caller(lb, form, x, w, s, groups, y)
                    outs[name], err = f32_split_check(name, runs[name], form, ref, M, K, N,
                                                      out_dtype)
                    if err:
                        print(err, flush=True)
                        return 1
                same = {name: torch.equal(o, outs["this"]) for name, o in outs.items()}
                times = {name: [] for name in runs}
                for name in list(runs) + list(runs)[::-1]:
                    times[name].append(median_ms(runs[name], flush))
                scaled = dense * s.float().reshape(-1) if form != "p4g" else dense
                lib_t = median_ms(lambda: torch.matmul(x, scaled), flush)
                nbytes = x.numel() * 4 + w.numel() + s.numel() * 2 + M * N * (
                    4 if out_dtype == torch.float32 else 2)
                b, c = nbytes / HBM * 1e3, 2 * 2 * M * K * N / TF32_FLOPS * 1e3
                lib_ms, bound_ms, ceil_ms = lib_ms + lib_t, bound_ms + b, ceil_ms + c
                print(f"fp32 split {label}: M = {M}, {K}x{N}: bound {max(b, c):.4f} ms (bytes "
                      f"{b:.4f}, two TF32 products {c:.4f}), library {lib_t:.4f} ms; " + "; ".join(
                          f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms ({runs[name].how})"
                          for name, ts in times.items())
                      + "; bit-equal to this: " + ", ".join(
                          f"{n} {'yes' if v else 'no'}" for n, v in same.items()), flush=True)
                for name, ts in times.items():
                    total[name] = [a + t for a, t in zip(total[name], ts)]
                del x, w, s, dense, scaled, ref, runs, outs
            print(f"fp32 split {label}: M = {M}, the shapes together: bound "
                  f"{max(bound_ms, ceil_ms):.4f} ms (bytes {bound_ms:.4f}, two TF32 products "
                  f"{ceil_ms:.4f}), library {lib_ms:.4f} ms; " + "; ".join(
                      f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms "
                      f"({100 * max(bound_ms, ceil_ms) / min(ts):.1f} % of the bound)"
                      for name, ts in total.items()), flush=True)
    # where this tree's time goes: its split form with parts cut out
    out = BUILD_DIR / "qmm_turns" / "f32_breakdown"
    sources = {}
    for name, edits in F32_BREAKDOWN.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in [*CSRC.glob("*.cuh"), CSRC / "quant_matmul.cu", CSRC / "quant_matmul_p4.cu"]:
            shutil.copy(f, d)
        text = (d / "qmm_split.cuh").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: qmm_split.cuh no longer has one {old.strip()!r}")
            text = text.replace(old, new)
        (d / "qmm_split.cuh").write_text(text)
        sources[f"{name}_quant_matmul"] = d / "quant_matmul.cu"
        sources[f"{name}_quant_matmul_p4"] = d / "quant_matmul_p4.cu"
    built = build(sources, "qmm_turns/f32_breakdown_libs", ptxas=True)
    variants = {name: (built[f"{name}_quant_matmul"], built[f"{name}_quant_matmul_p4"], None)
                for name in F32_BREAKDOWN}
    for M in (2, 8):
        for form in ("i8", "p4", "p4g"):
            total = dict.fromkeys(variants, 0.0)
            for K, N, out_dtype in LAYER:
                x, w, s, groups, _ = f32_operands(g, form, M, K, N)
                for name, lb in variants.items():
                    y = torch.empty((M, N), dtype=out_dtype, device="cuda")
                    total[name] += median_ms(f32_split_caller(lb, form, x, w, s, groups, y), flush)
                del x, w, s
            print(f"where the time goes, fp32 split {form} M = {M}, the four layer shapes: "
                  + "; ".join(f"{name} {ms:.4f} ms" for name, ms in total.items()), flush=True)
    return 0


def f32_turns(dirs: dict) -> int:
    """The fp32 split form of each build in turns and its breakdown, then
    the tensor-core form of each build in turns and this tree's promotion
    error (see the module's docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in full fp32
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    if f32_split_turns(dirs, flush, g):
        return 1
    libs = build({name: d / "quant_matmul_f32.cu" for name, d in dirs.items()},
                 "qmm_turns/f32", ptxas=True)
    once = BUILD_DIR / "qmm_turns" / "f32_promote_0"  # this tree, the sum promoted at the end
    once.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, once)
    text = (CSRC / "quant_matmul_f32.cu").read_text()
    if text.count(PROMOTE) != 1:
        raise RuntimeError(f"quant_matmul_f32.cu no longer has one {PROMOTE!r}")
    (once / "quant_matmul_f32.cu").write_text(text.replace(PROMOTE, "PROMOTE_K = 0;"))
    at_end = build({"promote_0": once / "quant_matmul_f32.cu"}, "qmm_turns/f32_promote_0_lib")
    for form in ("i8", "p4", "p4g"):
        total = {name: [0.0, 0.0] for name in libs}
        lib_ms = 0.0
        for K, N, _ in LAYER:
            x, w, s, groups, dense = f32_operands(g, form, F32_M, K, N)
            scale = s.float().reshape(-1) if form != "p4g" else None
            ref = x @ dense
            ref = ref * scale if scale is not None else ref
            unit = ref.abs().max()
            runs, outs = {}, {}
            for name, lib in libs.items():
                run = f32_caller(lib, form, x, w, s, groups, torch.empty_like(ref))
                got = outs[name] = run().clone()
                again = run()
                torch.cuda.synchronize()
                err = ((got - ref).abs().max() / unit).item()
                rel = ((got - ref).norm() / ref.norm()).item()
                if err > ATOL or rel > 1e-4 or not torch.equal(got, again):
                    print(f"qmm_turns: {name} fp32 {form} {K}x{N} disagrees with the plain "
                          f"version ({err:.3e} of the largest output, relative norm "
                          f"{rel:.3e}) or with itself", flush=True)
                    return 1
                runs[name] = run
            same = {name: torch.equal(o, outs["this"]) for name, o in outs.items()}
            times = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                times[name].append(median_ms(runs[name], flush, reps=5))
            lib_t = median_ms(lambda: torch.matmul(x, dense * scale if scale is not None
                                                   else dense), flush, reps=5)
            lib_ms += lib_t
            print(f"fp32 {form} M = {F32_M}, {K}x{N}: library {lib_t:.4f} ms; " + "; ".join(
                f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
                + "; bit-equal to this: " + ", ".join(f"{n} {'yes' if v else 'NO'}"
                                                      for n, v in same.items()), flush=True)
            for name, ts in times.items():
                total[name] = [a + t for a, t in zip(total[name], ts)]
            del x, w, s, dense, ref, runs, outs
        ops = 2 * F32_M * sum(K * N for K, N, _ in LAYER)
        print(f"fp32 {form} M = {F32_M}, the four shapes together: bound {ops / F32_FLOPS * 1e3:.4f} "
              f"ms (operations, 67 TFLOP/s fp32), two-product TF32 ceiling "
              f"{2 * ops / TF32_FLOPS * 1e3:.4f} ms, library {lib_ms:.4f} ms; " + "; ".join(
                  f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in total.items()),
              flush=True)
    # the promotion: this tree at w_down against an fp64 product
    K, N = 14336, 4096
    for form in ("i8", "p4", "p4g"):
        x, w, s, groups, dense = f32_operands(g, form, F32_M, K, N)
        exact = x.double() @ dense.double()
        if form != "p4g":
            exact = exact * s.double().reshape(-1)
        unit = exact.abs().max()
        errs, ms = {}, {}
        for label, lib in (("every 128", libs["this"]), ("at the end only", at_end["promote_0"])):
            y = torch.empty((F32_M, N), dtype=torch.float32, device="cuda")
            run = f32_caller(lib, form, x, w, s, groups, y)
            got = run()
            errs[label] = ((got.double() - exact).abs().max() / unit).item()
            ms[label] = median_ms(run, flush, reps=5)
        plain = x @ dense
        plain = plain * s.float().reshape(-1) if form != "p4g" else plain
        errs["plain fp32"] = ((plain.double() - exact).abs().max() / unit).item()
        print(f"fp32 {form} M = {F32_M}, {K}x{N}, max error against fp64 in units of the "
              f"largest output: " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "; ms with the sum promoted " + "; ".join(f"{k} {v:.4f}" for k, v in ms.items()),
              flush=True)
        del x, w, s, dense, exact, plain
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--f32", action="store_true",
                    help="time the fp32 forms (split and tensor-core) instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qmm_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = {"this": CSRC}
    for item in args.against:
        name, _, path = item.partition("=")
        p = Path(path)
        dirs[name] = p.parent if p.suffix == ".cu" else p
    if args.f32:
        return f32_turns(dirs)
    built = build({f"{name}_{src}": d / f"quant_matmul{'' if src == 'i8' else '_p4'}.cu"
                   for name, d in dirs.items() for src in ("i8", "p4")}, "qmm_turns", ptxas=True)
    libs = {src: {name: built[f"{name}_{src}"] for name in dirs} for src in ("i8", "p4")}
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_names = ("split_kernel", "qmm_partial", "qmm_finish", "p4_partial", "p4_finish")
    profiled = []
    for label, form, M, shapes in CASES:
        total = {name: [0.0, 0.0] for name in dirs}
        clean = dict.fromkeys(dirs, 0.0)
        lib_ms = bound_ms = 0.0
        for K, N, out_dtype in shapes:
            x, w, s, plain, dense = operands(g, form, M, K, N)
            ref = plain(x, w, s, out_dtype).float()
            unit = ref.abs().max()
            rtol = 2 ** -7 if out_dtype == torch.bfloat16 else ATOL
            runs = {name: caller(lib, form, x, w, s, out_dtype)
                    for name, lib in libs[ENTRY[form][0]].items()}
            outs = {}
            for name, run in runs.items():
                got = outs[name] = run().clone()
                again = run()
                torch.cuda.synchronize()
                excess = ((got.float() - ref).abs() / unit - ATOL - rtol * ref.abs() / unit
                          ).max().item()
                if excess > 0 or not torch.equal(got, again):
                    print(f"qmm_turns: {name} {form} M = {M} {K}x{N} disagrees with the plain "
                          f"version (excess {excess:.3e}) or with itself", flush=True)
                    return 1
            same = {name: torch.equal(got, outs["this"]) for name, got in outs.items()}
            order = list(runs) + list(runs)[::-1]
            times = {name: [] for name in runs}
            for name in order:
                times[name].append(median_ms(runs[name], flush))
            read = {name: read_flushed_ms(run, flush) for name, run in runs.items()}
            lib_t = median_ms(lambda: torch.matmul(x, dense), flush)
            nbytes = x.numel() * 2 + w.numel() + s.numel() * 2 + M * N * (
                4 if out_dtype == torch.float32 else 2)
            b = nbytes / HBM * 1e3
            lib_ms, bound_ms = lib_ms + lib_t, bound_ms + b
            print(f"{label}: M = {M}, {K}x{N}: bound {b:.4f} ms, library {lib_t:.4f} ms; "
                  + "; ".join(f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms "
                              f"({runs[name].how})" for name, ts in times.items())
                  + "; read-flushed " + ", ".join(f"{name} {t:.4f} ms" for name, t in read.items())
                  + "; bit-equal to this: " + ", ".join(f"{n} {'yes' if v else 'NO'}"
                                                        for n, v in same.items()),
                  flush=True)
            for name, ts in times.items():
                total[name] = [a + t for a, t in zip(total[name], ts)]
                clean[name] += read[name]
            if M == 2 or M == 32:
                profiled.append((f"{form} M = {M} {K}x{N}", runs, min(times["this"])))
            del x, w, s, dense, ref, runs
        print(f"{label}: M = {M}, the shapes together: bound {bound_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms; " + "; ".join(
                  f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms "
                  f"({100 * bound_ms / min(ts):.1f} % of the bound)"
                  for name, ts in total.items())
              + "; read-flushed " + ", ".join(f"{name} {t:.4f} ms ({100 * bound_ms / t:.1f} %)"
                                              for name, t in clean.items()), flush=True)
    # device time, after every library has run (a profiler session may miss
    # the kernels of a library first launched after an earlier one ended)
    for what, runs, event_ms in profiled:
        print(f"device time {what}: " + "; ".join(
            f"{name} {device_ms(run, flush, kernel_names):.4f} ms" for name, run in runs.items())
            + f" (CUDA events, this: {event_ms:.4f} ms)", flush=True)
    libs = breakdown_libs()
    for M, N in BREAKDOWN_MN:
        x, w, s, _, _ = operands(g, "i8", M, 4096, N)
        runs = {name: caller(lib, "i8", x, w, s, torch.float32) for name, lib in libs.items()}
        print(f"where the time goes, int8 M = {M}, 4096x{N} ({w.numel() / 1e6:.1f} MB, "
              f"{runs['full'].how}), read-flushed: " + "; ".join(
                  f"{name} {read_flushed_ms(run, flush):.4f} ms" for name, run in runs.items()),
              flush=True)
        del x, w, s, runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
