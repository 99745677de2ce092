"""Two-phase against streamed corpus inference at one token count, in turns,
on the card.

    python -m trace_tpu_torch.runtime.corpus_turns

The bench's default serving workload as ``chip_smoke.py`` phase 5 drives it:
TRACE-7B in the int8 serving configuration (int8 weights, int8 KV cache,
W8A8 prefill and ViT) with ``upload_format="yuv420"``, random weights from
seed 0, ``SpmLikeTokenizer``; a pool of 4 synthetic 640x360 128-frame videos
prepared with ``prepare_sample_host_np`` before timing and cycled through
a corpus of 64; ``infer_events_corpus`` at decode batch 32, prefill
sub-batches of 2, encode batches of 2 and a 512-token arena. The two modes
run at the same 512 new tokens, in turns (two-phase, streamed, streamed,
two-phase), so that a drift of the card shows as a spread and not as a
difference. Prints the card's name and power limit, then per run videos/s,
``last_corpus_stats``, decode steps and ms per step at B = 32, and the peak
GiB allocated; exits 1 unless every run's tokens equal the first run's.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 128
POOL = 4
BATCH = 32
BUDGET = 512    # the arena's new tokens, and every video's
VIDEOS = 64
HW = (360, 640)
ASK = ("Localize a series of activity events in the video, output the start "
       "and end timestamp for each event, and describe each event with sentences.")


def main() -> int:
    if not torch.cuda.is_available():
        print("corpus_turns: no CUDA device", file=sys.stderr)
        return 2
    from trace_tpu_torch.kernels import build
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import int8_serving
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime import generate as gen
    from trace_tpu_torch.runtime.pipeline import TracePipeline
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.build_all()
    cfg = dataclasses.replace(TraceConfig(), upload_format="yuv420")
    params, cfg = int8_serving(
        init_trace_params(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    pipe = TracePipeline(params, cfg, SpmLikeTokenizer())
    del params
    rng = np.random.default_rng(0)
    ts = [[round(i * 1.7, 1)] for i in range(FRAMES)]
    pool = [pipe.prepare_sample_host_np(
        rng.integers(0, 256, (FRAMES,) + HW + (3,), dtype=np.uint8), ts, ASK)
        for _ in range(POOL)]

    orig = gen.generate_split
    chunks: list = []

    def recording(*a, **k):
        out = orig(*a, **k)
        chunks.append((out.tokens, out.decode_steps))
        return out

    gen.generate_split = recording
    runs, first = [], None
    try:
        for streamed in (False, True, True, False):
            chunks.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe.infer_events_corpus(
                lambda i: pool[i % POOL], VIDEOS, encode_batch=2, decode_batch=BATCH,
                prefill_batch=2, max_new_tokens=BUDGET, token_budget=BUDGET,
                streamed=streamed)
            wall = time.perf_counter() - t0
            s = dict(pipe.last_corpus_stats)
            steps = sum(n for _, n in chunks)
            tokens = np.concatenate([t for t, _ in chunks])
            first = tokens if first is None else first
            s.update(mode="streamed" if streamed else "two-phase", new_tokens=BUDGET,
                     wall_s=wall, videos_per_s=VIDEOS / wall, decode_steps=steps,
                     ms_per_step=1e3 * s["decode_loop_s"] / max(steps, 1),
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                     tokens_equal_first=bool(np.array_equal(tokens, first)))
            runs.append(s)
            print(json.dumps(s), flush=True)
    finally:
        gen.generate_split = orig
    for mode in ("two-phase", "streamed"):
        vps = [r["videos_per_s"] for r in runs if r["mode"] == mode]
        print(f"{mode}: videos/s {' / '.join(f'{v:.4f}' for v in vps)}", flush=True)
    if not all(r["tokens_equal_first"] for r in runs):
        print("corpus_turns: the runs' tokens differ", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
