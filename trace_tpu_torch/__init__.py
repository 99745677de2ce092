"""trace_tpu_torch: the PyTorch/CUDA port of trace_tpu for one NVIDIA H100.

The JAX package ``trace_tpu`` is the reference; this package never imports
it (nor JAX) and keeps its own copies of what it needs. It carries the
serving path and the training path. Serving: frames -> CLIP ViT-L/14-336 -> spatial_slot connector ->
combined-table splice -> Mistral-7B prefill and head-FSM decode -> event
triplets, in four configurations: bf16; the int8 serving configuration
(``model.quantize.int8_serving``: int8 weights in the fused QKV / gate|up
layout, int8 KV cache, W8A8 prefill and ViT, weight-only decode steps); the
int4 one (``model.quantize.int4_serving``, ``model_init(quant="int4")``:
decoder layer weights per output channel in [-7, 7], nibble-packed,
weight-only at every chunk length, int8 KV cache); and the int4p serving
configuration (``model.quantize.int4p_serving``: decoder layer weights
nibble-packed int4 with group-128 scales, weight-only at every chunk length;
W4A8 prefill with per-channel scales).
Every Pallas kernel of those paths is a hand-written CUDA kernel under
``kernels/``: prefill, ViT and decode attention (bf16 and int8 cache), the
int8 weight product (2-D and layer-stacked) and the packed-int4 weight
products (per channel and grouped). The decoder may be Mistral, llama /
vicuna, qwen2 or Mixtral (routed experts, ``model.moe``; bf16 only).

Training (``train.train.train_loop``, ``python -m trace_tpu_torch.train.cli``):
the three-stream loss over ``model.trace_model.forward_train``, the stage
recipes ``pretrain`` / ``sft`` / ``lora`` on a hand-written AdamW, the data
pipeline, checkpoints and auto-resume, on one device. The decoder's attention
runs forward and backward through ``kernels.flash_attention
.flash_attention_trainable``: the forward kernel with a logsumexp output and
the dq and dk/dv backward kernels (``kernels/flash_backward.py``).

The public API of the JAX package (trace_tpu/__init__.py) and the port's
additions:

  model_init(path, quant=..., tokenizer=...) -> TracePipeline on the card,
                                               from a TRACE checkpoint dir
  infer_events(pipeline, video_path, instruction) -> EventPredictions
  infer(pipeline, video_path, instruct)       -> plain text
  x_infer(pipeline, video_path, question, mode) -> templated QA text
  TracePipeline(params, config, tokenizer)  -> runs on the card by default
  int8_serving(params, config)              -> the int8 serving pair
  int4_serving(params, config)              -> the int4 serving pair
  int4p_serving(params, config)             -> the int4p serving pair
  infer_events_batch(pipeline, frames, timestamps, instructions, ...)

``python -m trace_tpu_torch.runtime.serve_batch`` serves a folder of videos
into JSONL; ``python -m trace_tpu_torch.runtime.inference VIDEO`` prints one
video's events. The evaluation layer (``eval/``, ``metrics/``,
``task_prompts.py``) scores the VTG tasks (``python -m
trace_tpu_torch.eval.evaluate``) and MVBench / Video-MME (``python -m
trace_tpu_torch.eval.mcqa``).
"""

from trace_tpu_torch.runtime.pipeline import TracePipeline, model_init  # noqa: F401
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


def infer_events(pipeline: TracePipeline, video_path: str, instruction: str, **kw):
    """Single-video causal event inference from a video file."""
    return pipeline.infer_events(video_path, instruction, **kw)


def infer(pipeline: TracePipeline, video_path: str, instruct: str, **kw):
    """Plain captioning / QA text from a video file (reference
    trace/__init__.py:23-75: no event decoding; generation starts on the
    text head)."""
    from trace_tpu_torch.video.io import load_video_frames

    frames, ts = load_video_frames(video_path, pipeline.config.num_frames)
    return pipeline.infer_text(frames, ts, instruct, **kw)


def x_infer(pipeline: TracePipeline, video_path: str, question: str,
            mode: str = "vanilla", **kw):
    """Instruction-templated QA (reference trace/__init__.py:78-87): mode
    ``mcqa``, ``openend`` or ``vanilla``."""
    if mode == "mcqa":
        instruction = (
            f"{question}\nAnswer with the option's letter from the given "
            "choices directly and only give the best option."
        )
    elif mode == "openend":
        instruction = (
            f"{question}\nAnswer the question using a single word or a short "
            "phrase with multiple words."
        )
    elif mode == "vanilla":
        instruction = question
    else:
        raise ValueError(f"unknown x_infer mode: {mode}")
    return infer(pipeline, video_path, instruction, **kw)
