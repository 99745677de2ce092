"""Every attention row at head dims 64 and 128 through two trees' wrappers,
in turns, on the card: outputs bit for bit, times side by side.

    python -m trace_tpu_torch.kernels.attn_tree_turns --against parent=ROOT

ROOT is the root of another checkout of the repository (say an earlier
commit unpacked with ``git archive`` into a gitignored directory). For this
tree and ROOT in turns (ROOT, this, this, ROOT), each in a process of its
own that imports that tree's ``trace_tpu_torch`` (and builds its kernels
there), it calls each wrapper at ``chip_smoke.py`` phase 3's shapes, in bf16
and in fp32, from inputs made from seed 0: ``flash_attention`` (row 1: q [2,
32, 2048, hd], k / v [2, 8, 2048, hd], causal, row 0 left-padded by 300),
``flash_attention_fwd_res`` (row 8: right-padded) and, from its residuals,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` (rows 9, 10),
each at hd 128 and 64; ``vit_attention_btd`` (row 2: fused-QKV slices [16,
592, 1024], 16 heads, tq 577); ``decode_attention`` over a bf16 (fp32)
stripe and over an int8 one in both bodies (rows 3, 3b: q [4, 32, 1, hd],
stripe [4, 8, 2304, hd], half the slots masked) at hd 128 and 64. Per call:
the median of 20 CUDA-event times with the L2 flushed before each, and
whether its outputs equal ROOT's first run's bit for bit. The card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def worker(root: str, out: str) -> None:
    """In a process of its own: ``root``'s wrappers on every case; one JSON
    line each, the outputs saved to ``out``."""
    sys.path.insert(0, root)
    import torch

    from trace_tpu_torch.kernels import flash_backward as fb
    from trace_tpu_torch.kernels.decode_attention import decode_attention
    from trace_tpu_torch.kernels.flash_attention import flash_attention, vit_attention_btd
    from trace_tpu_torch.model.mistral import _quantize_kv

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            flush.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    outs = {}

    def case(name, fn):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        outs[name] = [x.cpu() for x in got]
        print(json.dumps({"case": name, "ms": median_ms(fn)}), flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        g = torch.Generator(device="cuda").manual_seed(0)
        randn = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
        for hd in (128, 64):
            q, k, v, do = randn(2, 32, 2048, hd), randn(2, 8, 2048, hd), \
                randn(2, 8, 2048, hd), randn(2, 32, 2048, hd)
            left = torch.zeros((2, 2048), device="cuda")
            left[0, :300] = -1e30
            right = torch.zeros((2, 2048), device="cuda")
            right[0, -300:] = -1e30
            do[0, :, -300:] = 0
            case(f"row 1 {tag} hd {hd}", lambda: flash_attention(q, k, v, left, True))
            case(f"row 8 {tag} hd {hd}",
                 lambda: fb.flash_attention_fwd_res(q, k, v, right, causal=True))
            o, lse = fb.flash_attention_fwd_res(q, k, v, right, causal=True)
            delta = fb.flash_attention_bwd_delta(o, do)
            args = (q, k, v, right, do, lse, delta)
            case(f"row 9 {tag} hd {hd}", lambda: fb.flash_attention_bwd_dq(*args, causal=True))
            case(f"row 10 {tag} hd {hd}",
                 lambda: fb.flash_attention_bwd_dkv(*args, causal=True))
            del q, k, v, do, o, lse, delta, args
            q = randn(4, 32, 1, hd)
            kf, vf = randn(4, 8, 2304, hd), randn(4, 8, 2304, hd)
            bias = torch.where(torch.rand((4, 2304), generator=g, device="cuda") < 0.5,
                               0.0, -1e30).float()
            case(f"row 3 {tag} hd {hd}", lambda: decode_attention(q, kf, vf, bias))
            (kq, ks), (vq, vs) = (_quantize_kv(x.to(torch.bfloat16)) for x in (kf, vf))
            stripe = {"kq": kq, "ks": ks.contiguous(), "vq": vq, "vs": vs.contiguous()}
            for mode in ("s8dot", "dequant"):
                case(f"row 3b {mode} {tag} hd {hd}",
                     lambda: decode_attention(q, stripe, None, bias, mode=mode))
            del q, kf, vf, kq, vq, stripe
        qkv = randn(16, 592, 3072)
        q, k, v = qkv.split(1024, dim=-1)
        case(f"row 2 {tag} hd 64", lambda: vit_attention_btd(q, k, v, 577, 16))
        del qkv, q, k, v
    torch.save(outs, out)


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
        print("attn_tree_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    name, _, root = args.against.partition("=")
    here = Path(__file__).resolve().parents[2]
    roots = {name: Path(root).resolve(), "this": here}
    order = [name, "this", "this", name]
    out_dir = here / "trace_tpu_torch" / "kernels" / "_build" / "attn_tree_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    got = {n: [] for n in roots}
    for i, n in enumerate(order):
        out = out_dir / f"{n}_{i}.pt"
        r = subprocess.run([sys.executable, __file__, "--against", args.against, "--worker",
                            str(roots[n]), str(out)], capture_output=True, text=True,
                           cwd=str(roots[n]))
        if r.returncode:
            print(f"attn_tree_turns: {n} failed:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}",
                  flush=True)
            return 1
        ms = {x["case"]: x["ms"] for x in map(json.loads, r.stdout.splitlines())
              if "case" in x}
        got[n].append((ms, torch.load(out)))
    first = got[name][0][1]
    unequal = []
    for key in first:
        same = all(all(torch.equal(a, b) for a, b in zip(outs[key], first[key]))
                   for runs in got.values() for _, outs in runs)
        times = "; ".join(f"{n} " + " / ".join(f"{ms[key]:.4f}" for ms, _ in runs)
                          for n, runs in got.items())
        print(f"{key}: {times} ms; bit-equal to {name}'s: {same}", flush=True)
        if not same:
            unequal.append(key)
    if unequal:
        print(f"attn_tree_turns: outputs differ from {name}'s: {unequal}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
