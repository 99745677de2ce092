"""trace_tpu_torch: the PyTorch/CUDA port of trace_tpu for one NVIDIA H100.

The JAX package ``trace_tpu`` is the reference; this package never imports
it (nor JAX) and keeps its own copies of what it needs. It carries the
serving path: frames -> CLIP ViT-L/14-336 -> spatial_slot connector ->
combined-table splice -> Mistral-7B prefill and head-FSM decode -> event
triplets, in three configurations: bf16; the int8 serving configuration
(``model.quantize.int8_serving``: int8 weights in the fused QKV / gate|up
layout, int8 KV cache, W8A8 prefill and ViT, weight-only decode steps); and
the int4p serving configuration (``model.quantize.int4p_serving``: decoder
layer weights nibble-packed int4 with group-128 scales, weight-only at every
chunk length; W4A8 prefill with per-channel scales).
Every Pallas kernel of those paths is a hand-written CUDA kernel under
``kernels/``: prefill, ViT and decode attention (bf16 and int8 cache), the
int8 weight product (2-D and layer-stacked) and the packed-int4 weight
products (per channel and grouped). Training is not ported yet.

  TracePipeline(params, config, tokenizer)  -> runs on the card by default
  int8_serving(params, config)              -> the int8 serving pair
  int4p_serving(params, config)             -> the int4p serving pair
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
