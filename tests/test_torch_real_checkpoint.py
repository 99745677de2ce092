"""Gated real-checkpoint tests of the port (stage 2 of
scripts/parity/run_all_torch.sh): the port's copy of
tests/test_real_checkpoint.py, with no JAX, so that it runs on a machine
without it:

    TRACE_TPU_REAL_CKPT=/path/to/ckpt python -m pytest --noconftest \\
        tests/test_torch_real_checkpoint.py

Skipped unless TRACE_TPU_REAL_CKPT names a TRACE checkpoint directory
(nothing is downloaded). On the model it finds, on the card when there is
one (else the CPU):

* the layout: ``python -m trace_tpu_torch.checkpoint.manifest --verify``
  exits 0;
* forward sanity: the prefill's combined logits are finite with a
  non-degenerate entropy, and greedy decoding emits structurally valid
  <time><score><caption> events;
* int8 against bf16: the free-running greedy tokens of the int8 decoder
  (per-channel weights, as ``quantize_decoder_params``) agree with bf16's in
  more than 0.9 of 64.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

CKPT = os.environ.get("TRACE_TPU_REAL_CKPT", "")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASK = ("Localize a series of activity events in the video, output the start and end "
       "timestamp for each event, and describe each event with sentences.")

pytestmark = pytest.mark.skipif(not CKPT, reason="set TRACE_TPU_REAL_CKPT=/path/to/ckpt")


@pytest.fixture(scope="module")
def pipe_bf16():
    from trace_tpu_torch.checkpoint.runbook import load_pipeline

    device = "cuda" if torch.cuda.is_available() else "cpu"
    return load_pipeline(CKPT, vision_path=os.environ.get("TRACE_TPU_REAL_VISION") or None,
                         device=device)


def _demo_video(T=16):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, size=(T, 360, 480, 3), dtype=np.uint8)
    return frames, [[round(i * 1.7, 1)] for i in range(T)]


def test_manifest_layout():
    r = subprocess.run([sys.executable, "-m", "trace_tpu_torch.checkpoint.manifest",
                        "--verify", CKPT], capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


def test_forward_sanity_and_event_structure(pipe_bf16):
    from trace_tpu_torch.model.mistral import compute_logits, decoder_forward

    frames, ts = _demo_video()
    prefix, mask = pipe_bf16.encode_prefix([frames], [ts], [ASK])
    pos = (mask.long().cumsum(-1) - 1).clamp_min(0)
    with torch.no_grad():
        h, _ = decoder_forward(pipe_bf16._decoder_params, pipe_bf16.config.decoder, prefix,
                               mask, pos)
        logits = compute_logits(pipe_bf16._decoder_params, h[:, -1])
    assert torch.isfinite(logits).all()
    p = torch.softmax(logits.double(), -1)
    entropy = float(-(p * p.clamp_min(1e-300).log()).sum())
    assert entropy > 1e-3, f"degenerate next-token distribution (entropy {entropy})"
    d = pipe_bf16.infer_events_from_frames(frames, ts, ASK, max_new_tokens=256).to_dict()
    assert isinstance(d.get("timestamps"), list)
    for pair in d["timestamps"]:
        assert len(pair) == 2 and all(isinstance(x, float) for x in pair)
    assert len(d.get("captions", [])) == len(d["timestamps"])


def test_int8_greedy_agreement(pipe_bf16):
    """Free-running greedy tokens of the int8 decoder against bf16's on the
    same prefix; the acceptance rule of PARITY.md (random-weight probes
    lower-bound what a trained model agrees)."""
    from trace_tpu_torch.model.quantize import fuse_decoder_serving, quantize_decoder_params
    from trace_tpu_torch.runtime.generate import generate

    frames, ts = _demo_video()
    prefix, mask = pipe_bf16.encode_prefix([frames], [ts], ["describe the events"])
    dec = pipe_bf16._decoder_params
    int8 = fuse_decoder_serving(quantize_decoder_params(dec))
    outs = {}
    for tag, tree in (("bf16", dec), ("int8", int8)):
        out = generate(tree, pipe_bf16.config.decoder, prefix.clone(), mask,
                       pipe_bf16._combined, max_new_tokens=64, initial_head=1,
                       temperature=0.0, seed=0)
        outs[tag] = out.tokens
    agree = float(np.mean(outs["bf16"] == outs["int8"]))
    print(json.dumps({"greedy_token_agreement_64": agree}))
    assert agree > 0.9, f"int8 free-running agreement {agree} <= 0.9"
