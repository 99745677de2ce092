"""Autoregressive generation with the TRACE output-head FSM
(trace_tpu/runtime/generate.py: prefill, decode loop, stop sequences, the
time-constraint trie).

* per-sequence head state is an int tensor in {0: text, 1: time, 2: score};
* head restriction is a [3, combined_vocab] additive mask table;
* head transitions follow the emitted token (text <sync> -> time,
  time <sync> -> score, score <sync> -> text);
* the next token's input embedding is one gather from the combined table.

The JAX package compiles the decode loop into one ``lax.while_loop``; here
it is a Python loop whose state stays on the device and which stops when
every row is done (one device->host read of ``done`` per step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from trace_tpu_torch.model.config import DecoderConfig
from trace_tpu_torch.model.mistral import (
    NEG_INF,
    compute_logits,
    decoder_forward,
    init_kv_cache,
)

PAD_OUTPUT_ID = -1  # emitted for steps after a sequence finished


def head_mask_table(config: DecoderConfig, device=None) -> torch.Tensor:
    """[3, combined_vocab] additive mask: 0 inside the head's slice, -1e30
    outside. Text head sees [0, V+1) (text + sync), time head
    [V+1, V+1+Vt), score head [V+1+Vt, V+1+Vt+Vs)."""
    v, vt, vs = config.vocab_size, config.time_vocab_size, config.score_vocab_size
    table = np.full((3, config.combined_vocab_size), NEG_INF, np.float32)
    table[0, : v + 1] = 0.0
    table[1, v + 1: v + 1 + vt] = 0.0
    table[2, v + 1 + vt: v + 1 + vt + vs] = 0.0
    return torch.from_numpy(table).to(device)


def swap_heads(config: DecoderConfig, head: torch.Tensor, token: torch.Tensor):
    """Head transition on the emitted token."""
    v, vt = config.vocab_size, config.time_vocab_size
    head = torch.where(token == v, 1, head)           # text <sync>  -> time
    head = torch.where(token == v + 1, 2, head)       # time <sync>  -> score
    head = torch.where(token == v + 1 + vt, 0, head)  # score <sync> -> text
    return head


@dataclasses.dataclass
class GenerateOutput:
    tokens: np.ndarray          # [B, max_new_tokens], PAD_OUTPUT_ID after finish
    num_generated: np.ndarray   # [B]
    decode_steps: int           # decoder forwards run by the decode loop
    # {"prefill_s", "decode_s"}, each ended by a device sync
    phase_times: dict


# ---------------------------------------------------------------------------
# trace-retrieval: constrain time-head decoding to the input frame timestamps
# ---------------------------------------------------------------------------
# The allowed 6-char values form a trie over the frames' fixed-width
# timestamps; per batch row the FSM tracks how many chars of the current
# value were emitted and which frames still match that prefix ([B, T] mask).

def _chars_at(frame_chars: torch.Tensor, value_pos: torch.Tensor) -> torch.Tensor:
    B, T, W = frame_chars.shape
    pos = value_pos.clamp(0, W - 1).long()
    return torch.gather(frame_chars, 2, pos[:, None, None].expand(B, T, 1))[..., 0]


def _time_constraint_logit_mask(config, frame_chars, alive, value_pos):
    """Additive [B, combined_vocab] mask for the time head under the trie."""
    B, T, W = frame_chars.shape
    vt = config.time_vocab_size
    chars_here = _chars_at(frame_chars, value_pos)  # [B, T]
    local = torch.arange(vt, device=frame_chars.device)
    char_allowed = (
        alive[:, :, None] & (chars_here[:, :, None] == local[None, None, :])
    ).any(dim=1)  # [B, vt]
    char_allowed = char_allowed & (value_pos < W)[:, None]
    boundary = (value_pos == 0) | (value_pos == W)
    allowed = char_allowed.clone()
    allowed[:, 0] = boundary  # <sync>
    allowed[:, 1] = boundary  # <sep>
    full = torch.zeros((B, config.combined_vocab_size), dtype=torch.float32,
                       device=frame_chars.device)
    full[:, config.vocab_size + 1: config.vocab_size + 1 + vt] = torch.where(
        allowed, 0.0, NEG_INF)
    return full


def _time_constraint_update(config, token, frame_chars, alive, value_pos):
    """Advance the trie state on the emitted token."""
    v = config.vocab_size
    local = token - (v + 1)
    in_time = (token >= v + 1) & (token < v + 1 + config.time_vocab_size)
    is_char = in_time & (local >= 2)
    is_reset = (~in_time) | (in_time & (local <= 1))  # sep/sync or leaving time

    chars_here = _chars_at(frame_chars, value_pos)
    new_alive = alive & (chars_here == local[:, None])
    alive = torch.where(is_char[:, None], new_alive, alive)
    value_pos = torch.where(is_char, value_pos + 1, value_pos)
    alive = torch.where(is_reset[:, None], torch.ones_like(alive), alive)
    value_pos = torch.where(is_reset, torch.zeros_like(value_pos), value_pos)
    return alive, value_pos


def _prefill(params, c, prefix_embeds, prefix_mask, *, cache_len, impl="auto"):
    """Prefill phase: returns (cache, cache_mask, last_hidden, next_pos).
    The cache is the (k, v) pair in the prefix's dtype, or the int8 dict
    when ``c.kv_cache_dtype == "int8"``."""
    B, P, D = prefix_embeds.shape
    dev = prefix_embeds.device
    cache = init_kv_cache(c, B, cache_len, dtype=prefix_embeds.dtype, device=dev)
    positions = (torch.cumsum(prefix_mask.int(), dim=1) - 1).clamp(min=0)
    hidden, cache = decoder_forward(
        params, c, prefix_embeds, prefix_mask, positions,
        cache=cache, cache_index=0,
        cache_mask=torch.zeros((B, cache_len), dtype=torch.bool, device=dev),
        impl=impl,
    )
    cache_mask = torch.nn.functional.pad(prefix_mask.bool(), (0, cache_len - P))
    last_hidden = hidden[:, -1, :]  # content is right-aligned
    next_pos = prefix_mask.int().sum(dim=1)
    return cache, cache_mask, last_hidden, next_pos


def _decode_from_state(
    params, c, cache, cache_mask, last_hidden, next_pos,
    combined_embed, initial_head, *,
    prefix_len, max_new_tokens, temperature, eos_id,
    constrain_time, frame_time_ids, generator, embed_dtype,
    stop_ids=None, impl="auto",
):
    """FSM decode loop from a prefilled cache. Returns (tokens [B, N],
    num_generated [B], decode_steps).

    ``stop_ids`` ([N, K], -1 left-padded): a rolling buffer of the last K
    emitted ids is compared with each stop sequence every step; a match ends
    the row (the matched ids are still emitted)."""
    B = last_hidden.shape[0]
    dev = last_hidden.device
    P = prefix_len
    mask_table = head_mask_table(c, dev)

    def stop_hit(recent):
        if stop_ids is None:
            return torch.zeros((B,), dtype=torch.bool, device=dev)
        pad = stop_ids < 0  # [N, K]
        return (pad[None] | (recent[:, None, :] == stop_ids[None])).all(-1).any(1)

    if constrain_time:
        assert frame_time_ids is not None
    else:
        frame_time_ids = torch.zeros((B, 1, 6), dtype=torch.long, device=dev)
    alive = torch.ones(frame_time_ids.shape[:2], dtype=torch.bool, device=dev)
    vpos = torch.zeros((B,), dtype=torch.long, device=dev)

    def pick_token(logits, head, alive, vpos):
        masked = logits + mask_table[head]
        if constrain_time:
            masked = masked + _time_constraint_logit_mask(
                c, frame_time_ids, alive, vpos)
        if temperature > 0.0:
            probs = torch.softmax(masked / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(masked, dim=-1)

    def update_constraint(tok, alive, vpos):
        if not constrain_time:
            return alive, vpos
        return _time_constraint_update(c, tok, frame_time_ids, alive, vpos)

    # first token from the prefill's last hidden state
    tok = pick_token(compute_logits(params, last_hidden, impl=impl), initial_head,
                     alive, vpos).long()
    K = 0 if stop_ids is None else stop_ids.shape[1]
    recent = torch.full((B, max(K, 1)), -2, dtype=torch.long, device=dev)
    recent[:, -1] = tok
    done = (tok == eos_id) | stop_hit(recent)
    head = swap_heads(c, initial_head, tok)
    alive, vpos = update_constraint(tok, alive, vpos)

    tokens = torch.full((B, max_new_tokens), PAD_OUTPUT_ID, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = tok
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)

    step = 1
    while step < max_new_tokens and not bool(done.all()):
        cur_embed = combined_embed[tok].to(embed_dtype)
        write_idx = P + step - 1  # slot of the token being fed in
        hidden, cache = decoder_forward(
            params, c, cur_embed[:, None, :], ones,
            (next_pos + step - 1)[:, None],
            cache=cache, cache_index=write_idx, cache_mask=cache_mask, impl=impl,
        )
        cache_mask[:, write_idx] = True
        tok = pick_token(compute_logits(params, hidden[:, -1, :], impl=impl), head,
                         alive, vpos).long()

        recent = torch.cat([recent[:, 1:], tok[:, None]], dim=1)
        newly_done = (tok == eos_id) | stop_hit(recent)
        tokens[:, step] = torch.where(done, PAD_OUTPUT_ID, tok)
        head = torch.where(done, head, swap_heads(c, head, tok))
        alive, vpos = update_constraint(tok, alive, vpos)
        done = done | newly_done
        step += 1

    num = (tokens != PAD_OUTPUT_ID).sum(dim=1)
    return tokens, num, step - 1


def pack_stop_sequences(stop_sequences, device=None) -> Optional[torch.Tensor]:
    """[[ids...], ...] -> [N, K] long, -1 LEFT-padded (or None if empty)."""
    if not stop_sequences:
        return None
    seqs = [list(map(int, s)) for s in stop_sequences if len(s) > 0]
    if not seqs:
        return None
    K = max(len(s) for s in seqs)
    arr = np.full((len(seqs), K), -1, np.int64)
    for i, s in enumerate(seqs):
        arr[i, K - len(s):] = s
    return torch.from_numpy(arr).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    params: dict,
    config: DecoderConfig,
    prefix_embeds: torch.Tensor,   # [B, P, D], content right-aligned
    prefix_mask: torch.Tensor,     # [B, P] bool
    combined_embed: torch.Tensor,  # [CV, D]
    *,
    max_new_tokens: int = 1024,
    initial_head: int = 1,
    temperature: float = 0.0,
    eos_id: int = 2,
    seed: int = 0,
    pad_to_multiple: int = 128,
    constrain_time: bool = False,
    frame_time_ids: Optional[torch.Tensor] = None,
    stop_sequences=None,
    impl: str = "auto",
) -> GenerateOutput:
    """Left-pad the prefix to a bucket of ``pad_to_multiple``, prefill a
    static cache of ``bucket + max_new_tokens`` slots, and run the FSM
    decode loop.

    ``initial_head`` defaults to 1 (time head): the production prompt ends
    with ``<sync>``. Prefill runs through ``flash_attention`` and each step
    through ``decode_attention`` (their plain versions on the CPU or with
    ``impl="plain"``). Greedy decoding (temperature 0) is token-exact with
    the JAX package at fp32; with temperature > 0 tokens are drawn with
    ``torch.multinomial`` from a ``torch.Generator`` seeded with ``seed``,
    which matches JAX's sampler in distribution, not bit for bit."""
    B, P, D = prefix_embeds.shape
    dev = prefix_embeds.device
    bucket = max(pad_to_multiple, -(-P // pad_to_multiple) * pad_to_multiple)
    if bucket != P:
        pad = bucket - P
        prefix_embeds = torch.nn.functional.pad(prefix_embeds, (0, 0, pad, 0))
        prefix_mask = torch.nn.functional.pad(prefix_mask, (pad, 0))
    prefix_mask = prefix_mask.bool()
    cache_len = bucket + max_new_tokens

    t0 = time.perf_counter()
    cache, cache_mask, last_hidden, next_pos = _prefill(
        params, config, prefix_embeds, prefix_mask,
        cache_len=cache_len, impl=impl,
    )
    del prefix_embeds
    _sync(dev)
    t1 = time.perf_counter()

    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(seed)
    heads = torch.full((B,), initial_head, dtype=torch.long, device=dev)
    tokens, num, steps = _decode_from_state(
        params, config, cache, cache_mask, last_hidden, next_pos,
        combined_embed, heads,
        prefix_len=bucket, max_new_tokens=max_new_tokens,
        temperature=temperature, eos_id=eos_id,
        constrain_time=constrain_time,
        frame_time_ids=(None if frame_time_ids is None
                        else frame_time_ids.to(dev).long()),
        generator=generator, embed_dtype=last_hidden.dtype,
        stop_ids=pack_stop_sequences(stop_sequences, dev), impl=impl,
    )
    tokens_np = tokens.cpu().numpy()  # waits for the decode loop
    phase_times = {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}
    return GenerateOutput(tokens=tokens_np, num_generated=num.cpu().numpy(),
                          decode_steps=steps, phase_times=phase_times)
