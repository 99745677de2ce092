"""The PyTorch/CUDA port's twin of scripts/inference/serve_batch.py: batch
causal-event inference over a directory (or glob) of videos through
``trace_tpu_torch``'s corpus path, one JSONL line per video, with the JAX
script's flags, on the CUDA card unless ``--device cpu``.

    python scripts/inference/serve_batch_torch.py \\
        --model-path CKPT [--vision-path CLIP] \\
        --videos DIR_OR_GLOB [--instruction "..."] \\
        --out results.jsonl --batch 32 --frames 128 [--quant int8] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> dict:
    from trace_tpu_torch.runtime.serve_batch import (
        build_argparser,
        collect_videos,
        serve,
        shard_paths,
    )

    ap = build_argparser()
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card by default, or cpu")
    args = ap.parse_args(argv)
    paths, out = shard_paths(collect_videos(args.videos), args.out,
                             args.num_shards, args.shard)
    if not paths:
        raise SystemExit(f"no videos matched {args.videos!r}")

    from trace_tpu_torch.runtime.pipeline import model_init

    pipe = model_init(args.model_path, vision_path=args.vision_path, quant=args.quant,
                      device=args.device)
    result = serve(pipe, paths, out, instruction=args.instruction, frames=args.frames,
                   batch=args.batch, max_new_tokens=args.max_new_tokens,
                   streamed=args.streamed, constrain_time=args.constrain_time,
                   max_side=args.max_side)
    print(f"{result['ok']}/{len(paths)} videos -> {out} "
          f"({result['videos_per_s']:.2f} videos/s)")
    return result


if __name__ == "__main__":
    main()
