"""Text tokenization and modal-sentinel splicing.

Copy of trace_tpu/tokenizers/text.py (``ByteTokenizer``,
``SpmLikeTokenizer``, ``HFTokenizerAdapter``, ``load_hf_tokenizer``,
``splice_modal_tokens``). ``transformers`` is imported only by
``load_hf_tokenizer``: a machine without it runs the other tokenizers.

The LM prompt contains literal modal tags (``<video>``, ``<sync>``, ...) which
must become negative sentinel ids interleaved with real text token ids, to be
replaced by computed embeddings at fusion time.  Behavioral reference:
tokenizer_MMODAL_token_all (reference trace/mm_utils.py:519-554).
"""

from __future__ import annotations

import re
from typing import Protocol, Sequence

from trace_tpu_torch.constants import DEFAULT_MODAL_TOKEN, MODAL_TOKEN_INDEX

_MODAL_PATTERN = re.compile("|".join(re.escape(t) for t in DEFAULT_MODAL_TOKEN.values()))


class TextTokenizer(Protocol):
    """Minimal tokenizer surface the framework depends on."""

    bos_token_id: int
    eos_token_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]:
        """Text -> ids, including a leading BOS (HF `input_ids` convention)."""
        ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        ...


class ByteTokenizer:
    """Deterministic byte-level tokenizer for tests and synthetic pipelines.

    id layout: 0 = pad, 1 = bos, 2 = eos, 3..258 = bytes. Round-trips any
    UTF-8 text without external assets.
    """

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [self.bos_token_id] + [3 + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(int(i) - 3 for i in ids if 3 <= int(i) < 259)
        return data.decode("utf-8", errors="replace")


class SpmLikeTokenizer:
    """Deterministic word-piece tokenizer with SentencePiece-like token
    statistics: one piece per word/punctuation mark, long words split at 7
    chars (~1.15 pieces/word on English).

    Purpose: synthetic pipelines whose SEQUENCE LENGTHS should match
    production (the Mistral SPM model averages ~4 chars/token on English;
    :class:`ByteTokenizer` inflates the same prompt ~4x). On the llama_2 DVC
    prompt (697 chars) this tokenizer emits 173 tokens vs ~165 for the real
    Mistral SPM.

    Ids are assigned lazily in first-seen order from 259 upward, so encode
    is deterministic for a fixed call sequence and decode inverts exactly
    (pieces are joined with single spaces). Not thread-safe: call it from
    one thread.
    """

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    vocab_size = 32000  # production Mistral text-vocab size

    _PIECES = re.compile(r"[A-Za-z0-9]+|[^A-Za-z0-9\s]")
    _MAX_PIECE = 7

    def __init__(self) -> None:
        self._piece_to_id: dict[str, int] = {}
        self._id_to_piece: dict[int, str] = {}

    def _piece_id(self, piece: str) -> int:
        pid = self._piece_to_id.get(piece)
        if pid is None:
            pid = 259 + (len(self._piece_to_id) % (self.vocab_size - 259))
            self._piece_to_id[piece] = pid
            self._id_to_piece.setdefault(pid, piece)
        return pid

    def encode(self, text: str) -> list[int]:
        ids = [self.bos_token_id]
        for m in self._PIECES.finditer(text):
            w = m.group(0)
            if w.isalnum():
                for i in range(0, len(w), self._MAX_PIECE):
                    ids.append(self._piece_id(w[i : i + self._MAX_PIECE]))
            else:
                ids.append(self._piece_id(w))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return " ".join(
            self._id_to_piece[int(i)] for i in ids if int(i) in self._id_to_piece
        )


class HFTokenizerAdapter:
    """Wrap a HuggingFace tokenizer loaded from a local path (no hub access)."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id
        self.vocab_size = len(hf_tokenizer)

    def encode(self, text: str) -> list[int]:
        return self._tok(text).input_ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)


def load_hf_tokenizer(path: str) -> HFTokenizerAdapter:
    """The tokenizer saved in a checkpoint dir, through ``transformers``'
    ``AutoTokenizer`` (local files only)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {path} needs the transformers package, "
            "which is not installed; pass a tokenizer object instead "
            "(model_init(..., tokenizer=...))") from e
    return HFTokenizerAdapter(
        AutoTokenizer.from_pretrained(path, use_fast=True, local_files_only=True))


def splice_modal_tokens(
    prompt: str,
    tokenizer: TextTokenizer,
) -> list[int]:
    """Prompt with literal modal tags -> ids with negative sentinel splices.

    The prompt is split on every modal tag; the first chunk keeps its BOS,
    later chunks drop theirs; each tag becomes its negative sentinel id.
    """
    chunks = _MODAL_PATTERN.split(prompt)
    tags = _MODAL_PATTERN.findall(prompt)

    chunk_ids = [tokenizer.encode(c) for c in chunks]
    offset = 0
    if chunk_ids and chunk_ids[0] and chunk_ids[0][0] == tokenizer.bos_token_id:
        offset = 1

    input_ids: list[int] = list(chunk_ids[0])
    for ids, tag in zip(chunk_ids[1:], tags):
        input_ids.append(MODAL_TOKEN_INDEX[tag[1:-1].upper()])
        input_ids.extend(ids[offset:])
    return input_ids
