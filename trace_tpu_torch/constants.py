"""Token-space and shape constants for the PyTorch/CUDA TRACE port.

Defines the combined 32,027-id output space of the causal-event decoder and the
negative sentinel ids used to splice multimodal content into text token streams.

Behavioral reference: reference trace/constants.py:6-58 and
reference trace/model/language_model/trace_mistral.py:86-96 (head layout).
A copy of trace_tpu/constants.py: the port keeps its own copy so that it
never imports the JAX package.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Frame budget (reference: trace/constants.py:6-8)
# ---------------------------------------------------------------------------
NUM_FRAMES = 8
MAX_FRAMES = 128
NUM_FRAMES_PER_SECOND = 1

# AnyRes image grids (reference: trace/constants.py:9)
GRIDS = [(2, 2), (1, 2), (1, 3), (1, 4), (2, 1), (3, 1), (4, 1)]

# ---------------------------------------------------------------------------
# Label masking
# ---------------------------------------------------------------------------
IGNORE_INDEX = -100

# ---------------------------------------------------------------------------
# Modal sentinel ids spliced into input_ids (negative => "not a text token").
# Reference: trace/constants.py:47.
# ---------------------------------------------------------------------------
MODAL_TOKEN_INDEX = {
    "IMAGE": -200,
    "VIDEO": -201,
    "AUDIO": -202,
    "TIME": -203,
    "SCORE": -204,
    "SYNC": -205,
}
MODAL_INDEX_TOKEN = {v: k for k, v in MODAL_TOKEN_INDEX.items()}

DEFAULT_MODAL_TOKEN = {
    "IMAGE": "<image>",
    "VIDEO": "<video>",
    "AUDIO": "<audio>",
    "TIME": "<time>",
    "SCORE": "<score>",
    "SYNC": "<sync>",
}

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"

# ---------------------------------------------------------------------------
# Combined output logit space (reference: trace_mistral.py:191-204, 248)
#
#   [0, 32000)                    text tokens (Mistral vocab)
#   32000                         <sync> (end-of-caption), produced by sync head
#   [32001, 32014)                time tokens  (<sync>, <sep>, 0-9, '.')
#   [32014, 32027)                score tokens (<sync>, <sep>, 0-9, '.')
# ---------------------------------------------------------------------------
TEXT_VOCAB_SIZE = 32000
TIME_VOCAB_SIZE = 13
SCORE_VOCAB_SIZE = 13

SYNC_TOKEN_ID = TEXT_VOCAB_SIZE  # 32000
TIME_OFFSET = TEXT_VOCAB_SIZE + 1  # 32001
SCORE_OFFSET = TIME_OFFSET + TIME_VOCAB_SIZE  # 32014
COMBINED_VOCAB_SIZE = SCORE_OFFSET + SCORE_VOCAB_SIZE  # 32027

TIME_SYNC_ID = TIME_OFFSET + 0  # 32001, time-field terminator
TIME_SEP_ID = TIME_OFFSET + 1  # 32002
SCORE_SYNC_ID = SCORE_OFFSET + 0  # 32014, score-field terminator
SCORE_SEP_ID = SCORE_OFFSET + 1  # 32015

# Head indices for the output-head finite-state machine.
HEAD_TEXT = 0
HEAD_TIME = 1
HEAD_SCORE = 2
NUM_HEADS = 3

# Head-switch rules (reference: trace_mistral.py:86-88 `swap_tokens`): emitting
# the key token switches the active head to the value for the NEXT step.
SWAP_TOKENS = {
    SYNC_TOKEN_ID: HEAD_TIME,   # text <sync>  -> decode timestamps next
    TIME_SYNC_ID: HEAD_SCORE,   # time <sync>  -> decode scores next
    SCORE_SYNC_ID: HEAD_TEXT,   # score <sync> -> decode caption next
}

# Per-head [lo, hi) slices of the combined logit vector
# (reference: trace_mistral.py:248).
HEAD_SLICES = (
    (0, TEXT_VOCAB_SIZE + 1),           # text + sync
    (TIME_OFFSET, SCORE_OFFSET),        # time
    (SCORE_OFFSET, COMBINED_VOCAB_SIZE),  # score
)

# Fixed-width float serialization (reference: time_encoder.py:58,
# score_encoder.py:58). 6 chars for timestamps => videos longer than 9999 s
# are rejected; 3 chars for scores.
TIME_FORMAT = "0>6.1f"
SCORE_FORMAT = "0>3.1f"
TIME_CHARS = 6
SCORE_CHARS = 3

# Visual token budget (reference: SpatialSlotPool num_slots=8 in the
# multimodal projector; 6 time chars per frame, trace_arch.py:237-257).
NUM_SLOTS_PER_FRAME = 8
TIME_TOKENS_PER_FRAME = TIME_CHARS  # the <sync> terminator is dropped
TOKENS_PER_FRAME = NUM_SLOTS_PER_FRAME + TIME_TOKENS_PER_FRAME  # 14
