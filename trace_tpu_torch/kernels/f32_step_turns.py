"""The fp32 quantized trees' decode step timed on two trees of the port, in
turns, on the card.

    python -m trace_tpu_torch.kernels.f32_step_turns --against parent=ROOT

ROOT is the root of another checkout of the repository (say an earlier
commit unpacked with ``git archive`` into a gitignored directory). For this
tree and ROOT in turns (ROOT, this, this, ROOT), each in a process of its
own that imports that tree's ``trace_tpu_torch``, it builds TRACE-7B's
decoder at full width in fp32 from seed 0 in the int8, int4 and int4p
serving configurations (``model/quantize.py``) at 2 layers (``chip_smoke.py``
phase 4's fp32 trees) and at 32, and runs a decode step of 2 rows over a
512-slot int8 cache (``decoder_forward`` at T = 1, the combined logits;
the weight products at M = 2): the median of 10 synchronised steps' wall
times, and under ``torch.profiler`` the CUDA operations one step
launches (device operations) and their busy time, and how far apart the
two trees' logits are. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

LAYERS = (2, 32)
MODES = ("int8", "int4", "int4p")
ROWS, SLOTS = 2, 512


def worker(root: str, out: str) -> None:
    """In a process of its own: ``root``'s decode step in every mode and
    depth; one JSON line each, the logits saved to ``out``."""
    sys.path.insert(0, root)
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.mistral import compute_logits, decoder_forward, init_kv_cache
    from trace_tpu_torch.model.quantize import int4_serving, int4p_serving, int8_serving
    from trace_tpu_torch.params import init_trace_params

    serving = {"int8": lambda p, c: int8_serving(p, c, vision=False), "int4": int4_serving,
               "int4p": lambda p, c: int4p_serving(p, c, vision=False)}
    logits = {}
    for layers in LAYERS:
        for mode in MODES:
            cfg = TraceConfig(dtype=torch.float32)
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                       num_layers=layers))
            params = init_trace_params(cfg, torch.Generator(device="cuda").manual_seed(0))
            params, cfg = serving[mode](params, cfg)
            dec, dp = cfg.decoder, params["decoder"]
            del params
            g = torch.Generator(device="cuda").manual_seed(1)
            cache = init_kv_cache(dec, ROWS, SLOTS, dtype=torch.float32, device="cuda")
            for name in ("kq", "vq"):
                cache[name].random_(-127, 128, generator=g)
                cache[name.replace("q", "s")].fill_(0.01)
            mask = torch.ones((ROWS, SLOTS), dtype=torch.bool, device="cuda")
            mask[:, -1] = False  # the step's own slot
            x = 0.02 * torch.randn((ROWS, 1, dec.hidden_size), generator=g, device="cuda")
            ones = torch.ones((ROWS, 1), dtype=torch.bool, device="cuda")
            pos = torch.full((ROWS, 1), SLOTS - 1, device="cuda")

            def step():
                h, _ = decoder_forward(dp, dec, x, ones, pos, cache=cache,
                                       cache_index=SLOTS - 1, cache_mask=mask)
                return compute_logits(dp, h[:, -1])

            for _ in range(3):
                step()
            walls = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                y = step()
                torch.cuda.synchronize()
            ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            logits[f"{mode}_{layers}"] = y.cpu()
            print(json.dumps({"mode": mode, "layers": layers,
                              "ms_per_step": statistics.median(walls),
                              "device_operations": len(ops) or "not measured",
                              "device_busy_ms": sum(e.time_range.elapsed_us() for e in ops) / 1e3
                              if ops else "not measured"}), flush=True)
            del dp, cache, y
            torch.cuda.empty_cache()
    torch.save(logits, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, metavar="NAME=ROOT")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("f32_step_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    name, _, root = args.against.partition("=")
    here = Path(__file__).resolve().parents[2]
    roots = {name: Path(root).resolve(), "this": here}
    order = [name, "this", "this", name]
    out_dir = here / "trace_tpu_torch" / "kernels" / "_build" / "f32_step_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    got = {n: [] for n in roots}
    for i, n in enumerate(order):
        out = out_dir / f"{n}_{i}.pt"
        r = subprocess.run([sys.executable, __file__, "--against", args.against, "--worker",
                            str(roots[n]), str(out)], capture_output=True, text=True,
                           cwd=str(roots[n]))
        if r.returncode:
            print(f"f32_step_turns: {n} failed:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}",
                  flush=True)
            return 1
        rows = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
        got[n].append((rows, torch.load(out)))
    for layers in LAYERS:
        for mode in MODES:
            key = f"{mode}_{layers}"
            parts = []
            for n, runs in got.items():
                rows = [next(x for x in rr if x["mode"] == mode and x["layers"] == layers)
                        for rr, _ in runs]
                ms = " / ".join("%.3f" % x["ms_per_step"] for x in rows)
                busy = " / ".join("%.3f" % x["device_busy_ms"] for x in rows)
                parts.append(f"{n} {ms} ms/step, {rows[0]['device_operations']} device "
                             f"operations, busy {busy} ms")
            this, other = got["this"][0][1][key], got[name][0][1][key]
            err = ((this - other).abs().max() / other.abs().max()).item()
            print(f"fp32 {mode} tree, {layers} layers, decode step at B = {ROWS}: "
                  + "; ".join(parts) + f"; logits {err:.3e} apart in units of the largest",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
