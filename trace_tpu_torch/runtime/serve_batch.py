"""Batch serving CLI (scripts/inference/serve_batch.py): causal-event
inference over a directory (or glob) of videos through the corpus path, one
JSONL line per video.

    python -m trace_tpu_torch.runtime.serve_batch \\
        --model-path CKPT [--vision-path CLIP] \\
        --videos DIR_OR_GLOB [--instruction "..."] \\
        --out results.jsonl --batch 32 --frames 128 [--quant int8]

``main(argv)`` parses the flags and builds the pipeline with ``model_init``;
``serve(pipe, paths, ...)`` runs the corpus and writes the JSONL, so a
caller with a pipeline of its own drives it directly. A video that fails to
load gets a line ``{"video": path, "error": ...}`` and a blank stand-in in
the corpus; the others get their timestamps, scores and captions.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".avi", ".mov", ".gif", ".npy")
DEFAULT_INSTRUCTION = (
    "Localize a series of activity events in the video, output the start "
    "and end timestamp for each event, and describe each event with "
    "sentences."
)


def collect_videos(spec: str) -> list:
    """The videos of a directory (by extension) or of a glob, sorted."""
    if os.path.isdir(spec):
        return sorted(
            os.path.join(spec, f)
            for f in os.listdir(spec)
            if f.lower().endswith(VIDEO_EXTS)
        )
    return sorted(glob.glob(spec))


def shard_paths(paths: list, out: str, num_shards: int, shard: int) -> tuple:
    """This worker's share of ``paths`` (every ``num_shards``-th from
    ``shard``) and its own output file; one shard keeps both as they are."""
    if num_shards <= 1:
        return paths, out
    root, ext = os.path.splitext(out)
    return paths[shard::num_shards], f"{root}_shard{shard}of{num_shards}{ext}"


def serve(pipe, paths: Sequence[str], out: str, *,
          instruction: str = DEFAULT_INSTRUCTION, frames: int = 128,
          batch: int = 32, max_new_tokens: int = 512, streamed: bool = True,
          constrain_time: bool = False, max_side: Optional[int] = 672) -> dict:
    """Run ``pipe.infer_events_corpus`` over ``paths`` and write one JSONL
    line per video to ``out``. Returns {"ok": videos served, "failed":
    videos that did not load, "seconds": corpus wall time, "videos_per_s"}.
    Prints the route video containers take on this machine first."""
    from trace_tpu_torch.video.io import container_reader, load_video_frames

    print(f"serve_batch: video containers read through {container_reader()}", flush=True)
    failed = {}

    def load_item(i):
        try:
            frames_u8, ts = load_video_frames(paths[i], frames, max_side=max_side or None)
        except Exception as e:  # recorded in the JSONL; the corpus goes on
            failed[i] = str(e)
            frames_u8 = np.zeros((frames, 64, 64, 3), np.uint8)
            ts = [[0.0]] * frames
        return frames_u8, ts, instruction

    t0 = time.perf_counter()
    preds = pipe.infer_events_corpus(
        load_item, len(paths),
        decode_batch=batch,
        max_new_tokens=max_new_tokens,
        constrain_time=constrain_time,
        streamed=streamed,
    )
    dt = time.perf_counter() - t0

    n_ok = 0
    with open(out, "w") as f:
        for i, (path, p) in enumerate(zip(paths, preds)):
            if i in failed:
                f.write(json.dumps({"video": path, "error": failed[i]}) + "\n")
                continue
            f.write(json.dumps({
                "video": path,
                "timestamps": p.timestamps,
                "scores": p.scores,
                "captions": p.captions,
            }) + "\n")
            n_ok += 1
    return {"ok": n_ok, "failed": len(failed), "seconds": dt,
            "videos_per_s": len(paths) / dt}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="TRACE batch serving (PyTorch/CUDA port)")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--videos", required=True, help="directory or glob")
    ap.add_argument("--instruction", default=DEFAULT_INSTRUCTION)
    ap.add_argument("--out", default="results.jsonl")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--quant", choices=["bf16", "int8", "int4", "int4p"], default="int8")
    ap.add_argument("--streamed", dest="streamed", action="store_true", default=True,
                    help="decode completed chunks while later chunks encode (default)")
    ap.add_argument("--two-phase", dest="streamed", action="store_false",
                    help="encode the whole corpus before decoding")
    ap.add_argument("--constrain-time", action="store_true",
                    help="trace-retrieval timestamp constraint")
    ap.add_argument("--max-side", type=int, default=672,
                    help="native pre-scaled decode cap (0 = native res; "
                         "the OpenCV route ignores it)")
    # fleet serving: shard the video list over independent workers (one
    # card each); each writes its own JSONL
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    paths, out = shard_paths(collect_videos(args.videos), args.out,
                             args.num_shards, args.shard)
    if not paths:
        raise SystemExit(f"no videos matched {args.videos!r}")

    from trace_tpu_torch.runtime.pipeline import model_init

    pipe = model_init(args.model_path, vision_path=args.vision_path, quant=args.quant)
    result = serve(pipe, paths, out, instruction=args.instruction, frames=args.frames,
                   batch=args.batch, max_new_tokens=args.max_new_tokens,
                   streamed=args.streamed, constrain_time=args.constrain_time,
                   max_side=args.max_side)
    print(f"{result['ok']}/{len(paths)} videos -> {out} "
          f"({result['videos_per_s']:.2f} videos/s)")
    return result


if __name__ == "__main__":
    main()
