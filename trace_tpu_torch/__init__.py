"""trace_tpu_torch: the PyTorch/CUDA port of trace_tpu for one NVIDIA H100.

The JAX package ``trace_tpu`` is the reference; this package never imports
it (nor JAX) and keeps its own copies of what it needs. This slice carries
the bf16 serving path: frames -> CLIP ViT-L/14-336 -> spatial_slot connector
-> combined-table splice -> Mistral-7B prefill and head-FSM decode -> event
triplets, with hand-written CUDA kernels for the three attention kernels of
that path (``kernels/``).

  TracePipeline(params, config, tokenizer)  -> runs on the card by default
  infer_events_batch(pipeline, frames, timestamps, instructions, ...)
"""

from trace_tpu_torch.runtime.pipeline import TracePipeline  # noqa: F401
from trace_tpu_torch.tokenizers.event_codec import (  # noqa: F401
    EventPredictions,
    decode_event_stream,
    encode_event_stream,
)

__version__ = "0.1.0"


def infer_events_batch(pipeline: TracePipeline, frames_u8_list, timestamps_list,
                       instructions, **kw):
    """Batched causal event inference on decoded frames."""
    return pipeline.infer_events_batch(frames_u8_list, timestamps_list,
                                       instructions, **kw)


def infer_events_from_frames(pipeline: TracePipeline, frames_u8, timestamps,
                             instruction: str, **kw):
    """Single-video causal event inference on decoded frames."""
    return pipeline.infer_events_from_frames(frames_u8, timestamps, instruction, **kw)


def infer_text(pipeline: TracePipeline, frames_u8, timestamps, instruct: str, **kw):
    """Plain captioning / QA text on decoded frames."""
    return pipeline.infer_text(frames_u8, timestamps, instruct, **kw)
