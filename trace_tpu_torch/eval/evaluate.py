"""VTG evaluation: dvc / tvg / vhd over annotation JSONs.

The port's copy of ``trace_tpu/eval/evaluate.py``; ``main(argv)`` parses
``argv`` (default ``sys.argv[1:]``) and returns the scores (None for a shard
run):

    python -m trace_tpu_torch.eval.evaluate --model-path CKPT --task tvg \
        --anno-path ANNO_DIR --video-path VIDEO_DIR [--quant int8]

Replaces trace/eval/evaluate.py + eval.sh's three-process pipeline with one
entry point that (a) actually batches inference (the reference indexes vids[i]
per chunk — effectively batch 1, eval/evaluate.py:296-302), and (b) chains
reformat + metrics in-process through the shared structured decoder.

Annotation format: {split}.caption_coco_format.json with an "annotations"
list of {image_id, caption, id, (duration, segments...)} records.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from trace_tpu_torch.task_prompts import TASK_TO_PROMPT as TASK_PROMPTS
from trace_tpu_torch.task_prompts import get_task_prompt as load_task_prompt


def load_annotations(anno_path: str, split: str, limit: Optional[int] = None) -> list[dict]:
    file_path = os.path.join(anno_path, f"{split}.caption_coco_format.json")
    with open(file_path) as f:
        data = json.load(f)["annotations"]
    return data[:limit] if limit else data


def run_vtg_eval(
    pipeline,
    task: str,
    anno_data: Sequence[dict],
    video_path: str,
    *,
    num_frames: int = 128,
    batch_size: int = 4,
    streamed: bool = False,
    max_new_tokens: int = 512,
    prompt_text: Optional[str] = None,
    progress: bool = True,
    corpus_mode: bool = True,
    constrain_time: bool = False,
) -> list[dict]:
    """Batched inference over the annotation list -> fmt-style result records
    [{'video', 'id', 'timestamps', 'scores', 'captions'}, ...].

    corpus_mode uses the two-phase pipeline (encode all, then batched decode)
    — the throughput configuration; constrain_time enables trace-retrieval
    timestamp alignment.
    """
    from trace_tpu_torch.video.io import load_video_frames

    prompt = prompt_text or load_task_prompt(task)

    items = []
    for j in anno_data:
        vname = j["image_id"].split("/")[-1]
        vid_path = os.path.join(video_path, vname)
        if not os.path.exists(vid_path):
            continue
        if task in ("tvg", "vhd"):
            question = prompt.format(j["caption"].strip())
        else:
            question = prompt
        items.append({"path": vid_path, "video": vname, "id": j["id"], "q": question})

    results = []
    t0 = time.time()

    if corpus_mode:
        # pre-filter unopenable media by container HEADER only — decoding a
        # frame here would be a second full demux pass over the corpus
        from trace_tpu_torch.video.io import probe_media

        goods = []
        for it in items:
            try:
                probe_media(it["path"])
                goods.append(it)
            except Exception as e:
                print(f"skipping {it['path']}: {e}")

        # mid-decode failures (header fine, stream corrupt) substitute black
        # frames so the batch shape holds; their results are dropped after
        decode_failed: dict[int, str] = {}

        def load_item(i):
            it = goods[i]
            try:
                # decode pre-scaled in the native swscale pass: >=2x the
                # ViT input size keeps the pad-square+resize quality while
                # HD sources never materialize at native res on the host
                frames, ts = load_video_frames(
                    it["path"], num_frames, max_side=672
                )
            except Exception as e:
                decode_failed[i] = str(e)
                frames = np.zeros((num_frames, 64, 64, 3), np.uint8)
                ts = [[0.0]] * num_frames
            return frames, ts, it["q"]

        preds = pipeline.infer_events_corpus(
            load_item, len(goods),
            encode_batch=min(2, batch_size), decode_batch=batch_size,
            max_new_tokens=max_new_tokens, constrain_time=constrain_time,
            streamed=streamed,
        )
        for i, (it, p) in enumerate(zip(goods, preds)):
            if i in decode_failed:
                print(f"skipping {it['path']}: {decode_failed[i]}")
                continue
            results.append({
                "video": it["video"], "id": it["id"],
                "timestamps": p.timestamps, "scores": p.scores,
                "captions": p.captions,
            })
        if progress:
            rate = len(results) / max(time.time() - t0, 1e-9)
            print(f"[{task}] {len(results)} videos ({rate:.2f} vid/s)")
        return results

    for start in range(0, len(items), batch_size):
        chunk = items[start : start + batch_size]
        frames_list, ts_list, goods = [], [], []
        for it in chunk:
            try:
                # decode pre-scaled in the native swscale pass: >=2x the
                # ViT input size keeps the pad-square+resize quality while
                # HD sources never materialize at native res on the host
                frames, ts = load_video_frames(
                    it["path"], num_frames, max_side=672
                )
                frames_list.append(frames)
                ts_list.append(ts)
                goods.append(it)
            except Exception as e:  # skip undecodable videos, like the reference
                print(f"skipping {it['path']}: {e}")
        if not goods:
            continue
        preds = pipeline.infer_events_batch(
            frames_list, ts_list, [it["q"] for it in goods],
            max_new_tokens=max_new_tokens,
        )
        for it, p in zip(goods, preds):
            results.append({
                "video": it["video"],
                "id": it["id"],
                "timestamps": p.timestamps,
                "scores": p.scores,
                "captions": p.captions,
            })
        if progress:
            done = start + len(chunk)
            rate = done / (time.time() - t0)
            print(f"[{task}] {done}/{len(items)} videos ({rate:.2f} vid/s)")
    return results


def score_results(
    task: str,
    results: list[dict],
    gt_file: str,
) -> dict:
    """fmt results -> reformat -> metric (the reformat_*/eval_* chain)."""
    from trace_tpu_torch.eval.reformat import reformat_dvc, reformat_tvg, reformat_vhd

    with open(gt_file) as f:
        gt = json.load(f)["annotations"]

    if task in ("dvc-anet", "dvc-anet-ft"):
        from trace_tpu_torch.metrics.dvc_anet import evaluate_anet_dvc

        refmt = reformat_dvc(results)
        gt_map = {}
        for j in gt:
            caps = [c.strip() + "." for c in j["caption"].split(".") if len(c) > 5]
            if len(caps) != len(j.get("segments", [])):
                continue
            gt_map[j["image_id"].split("/")[-1]] = {
                "timestamps": j["segments"],
                "sentences": caps,
            }
        return evaluate_anet_dvc(refmt, gt_map)

    if task.startswith("dvc"):
        import tempfile

        from trace_tpu_torch.metrics.dvc import eval_with_files

        refmt = reformat_dvc(results)
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            json.dump(refmt, f)
            pred_file = f.name
        return eval_with_files(pred_file, gt_file)

    if task == "tvg":
        from trace_tpu_torch.metrics.tvg import evaluate_tvg

        refmt = reformat_tvg(results)
        gt_ts = {j["id"]: j["timestamp"] for j in gt}
        return evaluate_tvg(refmt, gt_ts)

    if task == "vhd":
        from trace_tpu_torch.metrics.vhd import eval_submission

        gt_by_vid = {j["image_id"].split("/")[-1]: j for j in gt}
        submission = reformat_vhd(results, gt_by_vid)
        gt_list = [
            {
                "qid": j["id"],
                "duration": j["duration"],
                "relevant_windows": j.get("segments", []),
                "relevant_clip_ids": j.get("relevant_clip_ids", []),
                "saliency_scores": j.get("saliency_scores", []),
            }
            for j in gt
        ]
        return dict(eval_submission(submission, gt_list))

    raise ValueError(f"unknown task {task}")


def main(argv=None) -> Optional[dict]:
    import argparse

    ap = argparse.ArgumentParser(description="TRACE VTG evaluation (PyTorch/CUDA port)")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--task", required=True, choices=list(TASK_PROMPTS))
    ap.add_argument("--anno-path", required=True)
    ap.add_argument("--video-path", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--output-dir", default="eval_out")
    ap.add_argument("--num-frames", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--debug", action="store_true", help="first 10 samples")
    ap.add_argument("--sample-num", type=int, default=0)
    ap.add_argument("--quant", choices=["bf16", "int8", "int4", "int4p"], default="bf16",
                    help="int8 = weight-only serving quantization "
                         "(decode batch 32 on one chip; quality caveat in "
                         "BENCH_NOTES.md)")
    ap.add_argument("--streamed", action="store_true",
                    help="pipelined serving: decode completed chunks while "
                         "later chunks encode (split mode only)")
    ap.add_argument("--constrain-time", action="store_true",
                    help="trace-retrieval: constrain time-head decoding to "
                         "the input frame timestamps")
    # fleet eval: shard the annotation list over independent workers (one
    # chip each; the reference's eval loop is strictly single-device,
    # eval/evaluate.py:229). Works with any launcher; merge the per-shard
    # fmt_*.json files (dict-union) before scoring.
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard", type=int, default=0)
    args = ap.parse_args(argv)

    from trace_tpu_torch.runtime.pipeline import model_init

    pipeline = model_init(
        args.model_path, vision_path=args.vision_path, quant=args.quant
    )
    anno = load_annotations(args.anno_path, args.split,
                            limit=10 if args.debug else None)
    if args.sample_num > 0:
        import random

        anno = random.Random(42).sample(anno, args.sample_num)
    if args.num_shards > 1:
        anno = anno[args.shard :: args.num_shards]
        print(f"shard {args.shard}/{args.num_shards}: {len(anno)} samples")

    results = run_vtg_eval(
        pipeline, args.task, anno, args.video_path,
        num_frames=args.num_frames, batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        constrain_time=args.constrain_time,
        streamed=args.streamed,
    )

    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    shard_tag = f"_shard{args.shard}of{args.num_shards}" if args.num_shards > 1 else ""
    fmt_file = os.path.join(
        args.output_dir,
        f"fmt_{args.task}_{args.split}_f{args.num_frames}{shard_tag}.json",
    )
    with open(fmt_file, "w") as f:
        json.dump(results, f)
    print(f"wrote {fmt_file}")

    if args.num_shards > 1:
        # scoring a partial shard is misleading; merge shard files then score
        print("shard run: merge the fmt_*_shard*.json files and call "
              "score_results on the union")
        return None
    gt_file = os.path.join(args.anno_path, f"{args.split}.caption_coco_format.json")
    metrics = score_results(args.task, results, gt_file)
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == "__main__":
    main()
