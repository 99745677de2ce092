"""The checkpoint-parity runbook's stages on the port (no JAX), as
``scripts/parity/run_all_torch.sh`` runs them:

    python -m trace_tpu_torch.checkpoint.runbook convert CKPT [--vision-path DIR]
    python -m trace_tpu_torch.checkpoint.runbook triplets CKPT VIDEO [--vision-path DIR]

``convert`` (stage 1) builds the pipeline through ``model_init`` and prints
the parameter count; ``triplets`` (stage 3) serves one video through
``model_init`` in bf16 and in int8 and prints both event lists, and whether
they are identical. Both run on the card (``--device`` to choose another).
A directory without the tokenizer files ``transformers`` reads (or a
machine without ``transformers``) is served with ``SpmLikeTokenizer``, with
a note: the event structure holds, the caption text is not the model's.
"""

from __future__ import annotations

import argparse
import json
import sys

ASK = ("Localize a series of activity events in the video, output the start and end "
       "timestamp for each event, and describe each event with sentences.")


def checkpoint_tokenizer(path: str):
    """The checkpoint's tokenizer, else ``SpmLikeTokenizer`` (with a note)."""
    from trace_tpu_torch.tokenizers.text import SpmLikeTokenizer, load_hf_tokenizer

    try:
        return load_hf_tokenizer(path)
    except (ImportError, OSError, ValueError) as e:
        print(f"note: no tokenizer loaded from {path} ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]}); serving with SpmLikeTokenizer", flush=True)
        return SpmLikeTokenizer()


def load_pipeline(path: str, *, vision_path=None, quant: str = "bf16", device=None):
    from trace_tpu_torch.runtime.pipeline import model_init

    return model_init(path, vision_path=vision_path, quant=quant, device=device,
                      tokenizer=checkpoint_tokenizer(path))


def convert(args) -> int:
    import torch

    pipe = load_pipeline(args.ckpt, vision_path=args.vision_path, device=args.device)
    n = 0
    stack = [pipe.params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif torch.is_tensor(t):
            n += t.numel()
    print(f"converted OK: {n / 1e9:.2f}B params on {pipe.device}", flush=True)
    return 0


def triplets(args) -> int:
    outs = {}
    for quant in ("bf16", "int8"):
        pipe = load_pipeline(args.ckpt, vision_path=args.vision_path, quant=quant,
                             device=args.device)
        outs[quant] = pipe.infer_events(args.video, ASK, max_new_tokens=512).to_dict()
        del pipe
    print(json.dumps({"identical": outs["bf16"] == outs["int8"], **outs}, indent=2)[:4000])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the checkpoint-parity runbook's stages")
    sub = ap.add_subparsers(dest="stage", required=True)
    for name in ("convert", "triplets"):
        p = sub.add_parser(name)
        p.add_argument("ckpt")
        if name == "triplets":
            p.add_argument("video")
        p.add_argument("--vision-path", default=None)
        p.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    return convert(args) if args.stage == "convert" else triplets(args)


if __name__ == "__main__":
    sys.exit(main())
