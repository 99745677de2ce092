"""The PyTorch/CUDA port's twin of examples/inference.py: single-video causal
event inference through ``trace_tpu_torch`` (load a released checkpoint,
sample 64 frames, decode the event triplets), on the CUDA card unless
``--device cpu``.

    python examples/inference_torch.py --model-path CKPT \\
        [--vision-path CLIP_DIR] --video VIDEO.mp4 [--retrieval] [--device cpu]

``--retrieval`` constrains the timestamps to the input frames' (the port's
``constrain_time`` in ``runtime/generate.py``), through the corpus path, as
the JAX example does.
"""

import argparse
import json
import sys

sys.path.insert(0, ".")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="TRACE single-video events (PyTorch/CUDA port)")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--video", required=True)
    ap.add_argument("--question", default=(
        "Localize a series of activity events in the video, output the start "
        "and end timestamp for each event, and describe each event with "
        "sentences."
    ))
    ap.add_argument("--num-frames", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--retrieval", action="store_true",
                    help="constrain timestamps to input frame timestamps "
                         "(trace-retrieval behavior)")
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card by default, or cpu")
    args = ap.parse_args(argv)

    from trace_tpu_torch import model_init
    from trace_tpu_torch.video.io import load_video_frames

    pipe = model_init(args.model_path, vision_path=args.vision_path, device=args.device)

    if args.retrieval:
        frames, ts = load_video_frames(args.video, args.num_frames)
        preds = pipe.infer_events_corpus(
            lambda i: (frames, ts, args.question), 1,
            encode_batch=1, decode_batch=1,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            constrain_time=True,
        )[0]
    else:
        preds = pipe.infer_events(
            args.video, args.question,
            num_frames=args.num_frames,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
        )
    out = preds.to_dict()
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
