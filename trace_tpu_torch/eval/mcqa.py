"""MCQA benchmark runners: MVBench (20 subtasks) and Video-MME.

The port's copy of ``trace_tpu/eval/mcqa.py``; ``main(argv)`` parses ``argv``
(default ``sys.argv[1:]``) and returns the accuracies. "video"-type items and
Video-MME's ``.mp4`` files read through the native decoder alone
(``video/io.py``):

    python -m trace_tpu_torch.eval.mcqa --benchmark mvbench --model-path CKPT \
        --anno-path JSON_DIR --video-path VIDEO_ROOT

Re-designs trace/eval/mvbench/evaluate.py and trace/eval/videomme/evaluate.py
on the shared pipeline, fixing the reference defects catalogued in SURVEY.md
§2.9: no hard-coded 128-frame reshape (mvbench/evaluate.py:260), failures are
recorded instead of silently swallowed (bare except at :599-600), and
inference batches.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

MVBENCH_SYSTEM = (
    "Watch the video carefully, noticing the cause and sequence of events, "
    "and then choose the best option for the given question.\n"
)
MVBENCH_QUESTION_SUFFIX = (
    "\nPlease think step by step and only give the best option that matches "
    "the question best."
)
VIDEOMME_SYSTEM = (
    "Carefully watch the video and pay attention to the cause and sequence of "
    "events, the detail and movement of objects, and the action and pose of "
    "persons. Based on your observations, select the best option that "
    "accurately addresses the question.\n"
)
VIDEOMME_QUESTION_SUFFIX = "\nOnly give the best option."

# (json file, video subdir, reader, has start/end bounds) per subtask
# (reference: mvbench/evaluate.py:559-589)
MVBENCH_TASKS = {
    "Action Sequence": ("action_sequence.json", "star/Charades_v1_480/", "video", True),
    "Action Prediction": ("action_prediction.json", "star/Charades_v1_480/", "video", True),
    "Action Antonym": ("action_antonym.json", "ssv2_video/", "video", False),
    "Fine-grained Action": ("fine_grained_action.json", "Moments_in_Time_Raw/videos/", "video", False),
    "Unexpected Action": ("unexpected_action.json", "FunQA_test/test/", "video", False),
    "Object Existence": ("object_existence.json", "clevrer/video_validation/", "video", False),
    "Object Interaction": ("object_interaction.json", "star/Charades_v1_480/", "video", True),
    "Object Shuffle": ("object_shuffle.json", "perception/videos/", "video", False),
    "Moving Direction": ("moving_direction.json", "clevrer/video_validation/", "video", False),
    "Action Localization": ("action_localization.json", "sta/sta_video/", "video", True),
    "Scene Transition": ("scene_transition.json", "scene_qa/video/", "video", False),
    "Action Count": ("action_count.json", "perception/videos/", "video", False),
    "Moving Count": ("moving_count.json", "clevrer/video_validation/", "video", False),
    "Moving Attribute": ("moving_attribute.json", "clevrer/video_validation/", "video", False),
    "State Change": ("state_change.json", "perception/videos/", "video", False),
    "Fine-grained Pose": ("fine_grained_pose.json", "nturgbd/", "video", False),
    "Character Order": ("character_order.json", "perception/videos/", "video", False),
    "Egocentric Navigation": ("egocentric_navigation.json", "vlnqa/", "video", False),
    "Episodic Reasoning": ("episodic_reasoning.json", "tvqa/frames_fps3_hq/", "frame", True),
    "Counterfactual Inference": ("counterfactual_inference.json", "clevrer/video_validation/", "video", False),
}


def segment_midpoint_indices(
    num_segments: int,
    fps: float,
    max_frame: int,
    bound: Optional[tuple[float, float]] = None,
    first_idx: int = 0,
) -> tuple[np.ndarray, list[list[float]]]:
    """Midpoint-of-segment frame indices within an optional [start, end] bound
    (reference: mvbench/evaluate.py:231-244). Returns (indices, timestamps)."""
    if bound:
        start, end = bound
    else:
        start, end = -100000, 100000
    start_idx = max(first_idx, round(start * fps))
    end_idx = min(round(end * fps), max_frame)
    seg = float(end_idx - start_idx) / num_segments
    indices = np.array([
        int(start_idx + seg / 2 + np.round(seg * i)) for i in range(num_segments)
    ])
    indices = np.clip(indices, 0, max_frame)
    return indices, [[float(i) / fps] for i in indices]


def mvbench_qa(data: dict) -> tuple[str, str]:
    """Question with lettered options + '(X) answer' GT
    (reference: mvbench/evaluate.py:291-302)."""
    q = f"Question: {data['question']}\nOptions:\n"
    answer_idx = -1
    for i, c in enumerate(data["candidates"]):
        q += f"({chr(ord('A') + i)}) {c}\n"
        if c == data["answer"]:
            answer_idx = i
    return q.rstrip(), f"({chr(ord('A') + answer_idx)}) {data['answer']}"


def videomme_qa(data: dict) -> tuple[str, str]:
    """Options arrive pre-lettered as 'A. text' (videomme/evaluate.py:259-268)."""
    q = f"Question: {data['question']}\nOptions:\n"
    for c in data["options"]:
        q += f"({c[0]}) {c[3:]}\n"
    a = data["answer"]
    return q.rstrip(), f"({a}) {data['options'][ord(a) - ord('A')][3:]}"


def extract_option(text: str) -> str:
    """First lettered option in a response, e.g. '(b)' (check_ans regex,
    mvbench/evaluate.py:498-519). Falls back to 'a'."""
    found = re.findall(r"\(*\s*([a-z])\s*[\).]", text.lower())
    return found[0] if found else "a"


def check_ans(pred: str, gt: str) -> bool:
    pred_option = f"({extract_option(pred)})"
    gt_list = gt.lower().split(" ")
    gt_option = gt_list[0]
    return pred_option.replace(".", "") in gt_option or gt_option in pred_option


def _load_bounded_video(
    path: str, num_frames: int, bound, data_type: str
):
    """Decode frames by segment midpoints; 'frame' dirs are 3-fps image dumps."""
    from trace_tpu_torch.video import io as vio

    if data_type == "frame":
        files = sorted(
            f for f in os.listdir(path) if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        fps = 3.0
        indices, ts = segment_midpoint_indices(
            num_frames, fps, len(files) - 1, bound, first_idx=1
        )
        from PIL import Image

        frames = np.stack([
            np.asarray(Image.open(os.path.join(path, files[int(i) - 1])).convert("RGB"))
            for i in np.clip(indices, 1, len(files))
        ])
        return frames, ts

    duration, fps = vio.probe(path)
    indices, ts = segment_midpoint_indices(num_frames, fps, duration - 1, bound)
    # 2x the ViT input: HD sources decode pre-scaled in the native pass
    return vio.read_frames_at(path, indices, max_side=672), ts


def run_mvbench(
    pipeline,
    anno_path: str,
    video_path: str,
    *,
    num_frames: int = 128,
    batch_size: int = 4,
    max_new_tokens: int = 128,
    output_dir: Optional[str] = None,
    tasks: Optional[Sequence[str]] = None,
    limit_per_task: Optional[int] = None,
) -> dict:
    """MVBench MCQA: per-subtask and average accuracy; failures recorded."""
    samples = []
    for task, (fname, prefix, data_type, has_bound) in MVBENCH_TASKS.items():
        if tasks and task not in tasks:
            continue
        anno_file = os.path.join(anno_path, fname)
        if not os.path.exists(anno_file):
            continue
        with open(anno_file) as f:
            data = json.load(f)
        if limit_per_task:
            data = data[:limit_per_task]
        for d in data:
            bound = (d["start"], d["end"]) if has_bound and "start" in d else None
            q, a = mvbench_qa(d)
            samples.append({
                "task": task,
                "path": os.path.join(video_path, prefix, d["video"]),
                "bound": bound,
                "data_type": data_type,
                "question": MVBENCH_SYSTEM + q + MVBENCH_QUESTION_SUFFIX,
                "answer": a,
            })

    return _run_mcqa(
        pipeline, samples, num_frames=num_frames, batch_size=batch_size,
        max_new_tokens=max_new_tokens, output_dir=output_dir, group_key="task",
    )


def run_videomme(
    pipeline,
    anno_path: str,
    data_dir: str,
    *,
    num_frames: int = 128,
    batch_size: int = 4,
    max_new_tokens: int = 128,
    output_dir: Optional[str] = None,
    limit: Optional[int] = None,
    use_subtitles: bool = False,
    max_subtitle_len: int = 4096,
    tokenizer=None,
) -> dict:
    """Video-MME MCQA with duration-category accuracy (short/medium/long).

    use_subtitles enables the with-subtitles setting: `<data_dir>/subtitle/
    <videoID>.vtt` is parsed, deduplicated, token-truncated, and placed
    BEFORE the video token in the prompt (reference
    videomme/evaluate.py:287-294,322-323; a missing/broken .vtt degrades to
    the no-subtitle prompt like the reference's except path)."""
    with open(anno_path) as f:
        records = json.load(f)
    if limit:
        records = records[:limit]

    samples = []
    for rec in records:
        video_name = rec["url"].split("watch?v=")[1] if "url" in rec else rec["videoID"]
        path = os.path.join(data_dir, "data", video_name + ".mp4")
        subtitle = ""
        if use_subtitles:
            from trace_tpu_torch.eval.subtitles import read_vtt_and_concatenate

            vtt = os.path.join(data_dir, "subtitle", video_name + ".vtt")
            try:
                subtitle = read_vtt_and_concatenate(
                    vtt, tokenizer, max_len=max_subtitle_len
                )
            except OSError:
                subtitle = ""
        # subtitle text leads the video token; build_trace_prompt keeps a
        # pre-placed <video> tag where the caller put it
        pre = (
            f"This video's subtitles are listed below: {subtitle}\n<video>\n"
            if subtitle else ""
        )
        questions = rec.get("questions", [rec] if "question" in rec else [])
        for qd in questions:
            q, a = videomme_qa(qd)
            samples.append({
                "task": rec.get("duration", rec.get("duration_category", "unknown")),
                "path": path,
                "bound": None,
                "data_type": "video",
                "question": pre + VIDEOMME_SYSTEM + q + VIDEOMME_QUESTION_SUFFIX,
                "answer": a,
            })

    return _run_mcqa(
        pipeline, samples, num_frames=num_frames, batch_size=batch_size,
        max_new_tokens=max_new_tokens, output_dir=output_dir, group_key="task",
    )


def _run_mcqa(
    pipeline,
    samples: list[dict],
    *,
    num_frames: int,
    batch_size: int,
    max_new_tokens: int,
    output_dir: Optional[str],
    group_key: str,
) -> dict:
    acc: dict[str, list[int]] = {}
    res_list = []
    failures = []

    for start in range(0, len(samples), batch_size):
        chunk = samples[start : start + batch_size]
        frames_list, ts_list, goods = [], [], []
        for s in chunk:
            try:
                frames, ts = _load_bounded_video(
                    s["path"], num_frames, s["bound"], s["data_type"]
                )
                frames_list.append(frames)
                ts_list.append(ts)
                goods.append(s)
            except Exception as e:
                failures.append({"path": s["path"], "error": str(e)})
        if not goods:
            continue
        preds = pipeline.infer_events_batch(
            frames_list, ts_list, [s["question"] for s in goods],
            max_new_tokens=max_new_tokens,
        )
        for s, p in zip(goods, preds):
            text = p.captions[0] if p.captions else ""
            ok = check_ans(text, s["answer"])
            group = s[group_key]
            acc.setdefault(group, [0, 0])
            acc[group][0] += int(ok)
            acc[group][1] += 1
            res_list.append({"pred": text, "gt": s["answer"], "group": group, "correct": ok})

    final = {k: 100.0 * v[0] / max(v[1], 1) for k, v in acc.items()}
    total_correct = sum(v[0] for v in acc.values())
    total = sum(v[1] for v in acc.values())
    final["Avg"] = 100.0 * total_correct / max(total, 1)
    final["num_failures"] = len(failures)

    if output_dir:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        with open(os.path.join(output_dir, "test.json"), "w") as f:
            json.dump({"acc_dict": acc, "res_list": res_list, "failures": failures}, f)
        with open(os.path.join(output_dir, "upload_leaderboard.json"), "w") as f:
            json.dump(final, f)
    return final


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description="MCQA benchmarks (MVBench / Video-MME)")
    ap.add_argument("--benchmark", choices=["mvbench", "videomme"], required=True)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--anno-path", required=True)
    ap.add_argument("--video-path", required=True)
    ap.add_argument("--output-dir", default="mcqa_out")
    ap.add_argument("--num-frames", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--use-subtitles", action="store_true",
                    help="Video-MME with-subtitles setting "
                         "(<video-path>/subtitle/<videoID>.vtt)")
    args = ap.parse_args(argv)

    from trace_tpu_torch.runtime.pipeline import model_init

    pipeline = model_init(args.model_path, vision_path=args.vision_path)
    if args.benchmark == "mvbench":
        final = run_mvbench(
            pipeline, args.anno_path, args.video_path,
            num_frames=args.num_frames, batch_size=args.batch_size,
            output_dir=args.output_dir, limit_per_task=args.limit,
        )
    else:
        final = run_videomme(
            pipeline, args.anno_path, args.video_path,
            num_frames=args.num_frames, batch_size=args.batch_size,
            output_dir=args.output_dir, limit=args.limit,
            use_subtitles=args.use_subtitles, tokenizer=pipeline.tokenizer,
        )
    print(json.dumps(final, indent=2))
    return final


if __name__ == "__main__":
    main()
