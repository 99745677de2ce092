"""Modality- and length-grouped batch ordering.

Re-implements the reference's LengthGroupedSampler behavior
(trace_trainer.py:62-132): samples are split by modality (sign of the
length), shuffled, arranged into length-sorted megabatches so co-batched
sequences have similar lengths (less padding waste), and megabatches are
shuffled so modalities do not interleave within a batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    mega_factor: int = 50,
    rng: Optional[np.random.Generator] = None,
) -> list[int]:
    """Shuffle, then sort by length within megabatches of
    mega_factor*batch_size (reference: trace_trainer.py:90-98 style)."""
    rng = rng or np.random.default_rng()
    idx = rng.permutation(len(lengths))
    mega = mega_factor * batch_size
    out: list[int] = []
    for start in range(0, len(idx), mega):
        chunk = idx[start : start + mega]
        chunk = sorted(chunk, key=lambda i: lengths[i], reverse=True)
        out.extend(int(i) for i in chunk)
    return out


def modality_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    seed: int = 0,
) -> list[int]:
    """Split by modality (positive = image/video, negative = text), length-
    group each side, then emit whole batches in shuffled order
    (reference: get_modality_length_grouped_indices, trace_trainer.py:62-87)."""
    rng = np.random.default_rng(seed)
    lengths = list(lengths)
    mm = [i for i, l in enumerate(lengths) if l > 0]
    lang = [i for i, l in enumerate(lengths) if l <= 0]

    def batches(indices: list[int]) -> list[list[int]]:
        if not indices:
            return []
        ordered = length_grouped_indices(
            [abs(lengths[i]) for i in indices], batch_size, rng=rng
        )
        ordered = [indices[j] for j in ordered]
        return [
            ordered[s : s + batch_size] for s in range(0, len(ordered), batch_size)
        ]

    all_batches = batches(mm) + batches(lang)
    rng.shuffle(all_batches)
    return [i for b in all_batches for i in b]


def split_to_even_chunks(
    indices: Sequence[int], lengths: Sequence[int], num_chunks: int
) -> list[list[int]]:
    """Greedy balanced split of one megabatch across data-parallel replicas
    (reference: split_to_even_chunks, trace_trainer.py:40-59)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    chunk_size = len(indices) // num_chunks
    chunks: list[list[int]] = [[] for _ in range(num_chunks)]
    sums = [0] * num_chunks
    for i in indices:
        best = min(range(num_chunks), key=lambda c: sums[c])
        chunks[best].append(i)
        sums[best] += lengths[i]
        if len(chunks[best]) == chunk_size:
            sums[best] = float("inf")
    return chunks
