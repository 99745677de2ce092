"""The PyTorch/CUDA port's twin of scripts/inference/inference.py: the same
single-video demo (load a converted checkpoint, sample the frames, build the
llama_2 prompt suffixed with <sync>, generate with the head-switching FSM
starting on the time head, print the events as JSON) through
``trace_tpu_torch``, on the CUDA card unless ``--device cpu``.

    MODEL_PATH=... python scripts/inference/inference_torch.py VIDEO.mp4 \\
        "Localize a series of activity events in the video, ..." [--device cpu]

``FRAMES`` (default 64) and ``MAX_NEW_TOKENS`` (default 1024) set the frames
sampled and the tokens generated, as for the JAX script.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

DEFAULT_INSTRUCTION = (
    "Localize a series of activity events in the video, output the start and end "
    "timestamp for each event, and describe each event with sentences."
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="TRACE single-video demo (PyTorch/CUDA port)")
    ap.add_argument("video")
    ap.add_argument("instruction", nargs="?", default=DEFAULT_INSTRUCTION)
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card by default, or cpu")
    args = ap.parse_args(argv)

    from trace_tpu_torch import model_init

    model_path = os.environ.get("MODEL_PATH")
    if not model_path:
        raise SystemExit("set MODEL_PATH to a converted TRACE checkpoint dir")
    pipe = model_init(model_path, device=args.device)
    events = pipe.infer_events(
        args.video, args.instruction,
        num_frames=int(os.environ.get("FRAMES", "64")),
        max_new_tokens=int(os.environ.get("MAX_NEW_TOKENS", "1024")),
    )
    out = {"timestamps": events.timestamps, "scores": events.scores,
           "captions": events.captions}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
