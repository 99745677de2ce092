"""Where the time of the packed-int4 tensor-core form goes, on the card.

    python -m trace_tpu_torch.kernels.p4_breakdown

Builds ``csrc/quant_matmul_p4.cu`` as it is and three variants of it, each
with part of the tensor-core form's work cut out: the producers'
dequantization (``no_dequant``: the weight tiles keep whatever shared memory
held), the consumers' wgmma (``no_wgmma``), or both (``copies``: what is left
is the copies, the barriers and the epilogue). Times each at the prefill
shapes of ``chip_smoke.py`` (M = 3886: the four grouped products of a fused
TRACE-7B layer, and ``wqkv`` per channel) with CUDA events, median of 10 with
the L2 flushed before each run, the versions in turns and then in reverse,
and prints one line per version. Only the full source is a kernel of the
port; the variants' outputs are meaningless.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from trace_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

M = 3886
SHAPES = ((4096, 6144, torch.bfloat16), (4096, 4096, torch.bfloat16),
          (4096, 28672, torch.float32), (14336, 4096, torch.bfloat16))
_DEQUANT = "    for (int it = 0; it < 2; ++it) {"   # the producers' dequantization loop
_WGMMA = "      wgmma_128(acc, sw128_desc("       # the consumers' products
VARIANTS = {
    "full": (),
    "no_dequant": ((_DEQUANT, "    for (int it = 0; it < 0; ++it) {"),),
    "no_wgmma": ((_WGMMA, "      if (0) wgmma_128(acc, sw128_desc("),),
    "copies": ((_DEQUANT, "    for (int it = 0; it < 0; ++it) {"),
               (_WGMMA, "      if (0) wgmma_128(acc, sw128_desc(")),
}


def build() -> dict[str, ctypes.CDLL]:
    src = (CSRC / "quant_matmul_p4.cu").read_text()
    out = BUILD_DIR / "p4_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has one {old.strip()!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def launch(lib, grouped: bool, x, qp, s, y) -> None:
    fn = lib.quant_matmul_p4_grouped_bf16 if grouped else lib.quant_matmul_p4_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(x.data_ptr(), qp.data_ptr(), s.data_ptr(), y.data_ptr(), None, x.shape[0],
             x.shape[1], qp.shape[1], 0, int(y.dtype == torch.float32),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")


def median_ms(fn, flush, reps: int = 10) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("p4_breakdown: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    layer = []
    for K, N, out_dtype in SHAPES:
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        qp = torch.randint(-128, 128, (K // 2, N), generator=g, device="cuda", dtype=torch.int8)
        s = (torch.rand((K // 128, N), generator=g, device="cuda") * 4e-3 + 1e-3).to(torch.bfloat16)
        layer.append((x, qp, s, torch.empty((M, N), dtype=out_dtype, device="cuda")))
    x, qp, s, y = layer[0]
    s_col = s[0].contiguous()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name]
        grouped = sum(median_ms(lambda c=c: launch(lib, True, *c), flush) for c in layer)
        wqkv = median_ms(lambda: launch(lib, False, x, qp, s_col, y), flush)
        times[name].append((grouped, wqkv))
    for name, runs in times.items():
        print(f"{name}: grouped layer (M = {M}, 4 shapes) "
              f"{' / '.join(f'{r[0]:.4f}' for r in runs)} ms, wqkv per channel "
              f"{' / '.join(f'{r[1]:.4f}' for r in runs)} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
