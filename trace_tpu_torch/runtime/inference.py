"""End-to-end single-video demo (scripts/inference/inference.py; reference:
scripts/inference/inference.py:15-128).

Load a converted checkpoint, decode+sample 64 frames, build the production
llama_2 prompt suffixed with <sync>, generate with the head-switching FSM
starting on the time head, and print the structured events.

    MODEL_PATH=... python -m trace_tpu_torch.runtime.inference VIDEO.mp4 \\
        "Localize a series of activity events in the video, ..."

``FRAMES`` (default 64) and ``MAX_NEW_TOKENS`` (default 1024) set the frames
sampled and the tokens generated. ``main(argv)`` reads ``argv`` in place of
``sys.argv`` (its first item is the program's name) and returns the events
it printed.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None) -> dict:
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        raise SystemExit(1)
    video = argv[1]
    instruction = (
        argv[2]
        if len(argv) > 2
        else "Localize a series of activity events in the video, output the "
        "start and end timestamp for each event, and describe each event "
        "with sentences."
    )

    from trace_tpu_torch import model_init

    model_path = os.environ.get("MODEL_PATH")
    if not model_path:
        raise SystemExit("set MODEL_PATH to a converted TRACE checkpoint dir")
    pipe = model_init(model_path)
    events = pipe.infer_events(
        video, instruction,
        num_frames=int(os.environ.get("FRAMES", "64")),
        max_new_tokens=int(os.environ.get("MAX_NEW_TOKENS", "1024")),
    )
    out = {
        "timestamps": events.timestamps,
        "scores": events.scores,
        "captions": events.captions,
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
