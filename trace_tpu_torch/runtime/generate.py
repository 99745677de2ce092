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

The serving split (``generate_split``, ``generate(prefill_batch=)``):
prefill runs in sub-batches, each writing its rows of the KV cache in place
into one decode-batch cache (the "arena"), then one decode loop runs the
whole batch. ``generate_split`` reuses an arena handed in when its shapes
match, and ``token_budget`` sizes the cache and the token buffer for a
longer run than this one, whose loop stops at ``max_new_tokens``.
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
    local_kv_heads,
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
    # {"prefill_s", "decode_s"}, each ended by a device sync (None from
    # generate_split without time_phases)
    phase_times: Optional[dict]
    # generate_split: the KV arena, to hand to the next call
    cache: object = None


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


def prefill(params, c, prefix_embeds, prefix_mask, *, cache_len: int, impl: str = "auto",
            cache=None, tp_group=None):
    """The prefill phase, an entry point of its own (the JAX package's
    ``prefill_jit``): a cache of ``cache_len`` slots with the prefix
    [B, P, D] (content right-aligned) written into it. Returns (cache,
    cache_mask, last_hidden, next_pos) for ``decode``. The cache is the
    (k, v) pair in the prefix's dtype, or the int8 dict when
    ``c.kv_cache_dtype == "int8"``; ``cache`` (of ``init_kv_cache``'s shapes
    for this batch, e.g. a view of some rows of a larger cache) is written in
    place instead of a new one. Sub-batch caches made apart merge into one
    with ``merge_cache_rows``. ``tp_group``: the layers run tensor-parallel
    on this rank's shards (``decoder_forward``), the cache holding the
    rank's kv heads."""
    prefix_mask = prefix_mask.bool()
    B, P, D = prefix_embeds.shape
    dev = prefix_embeds.device
    if cache is None:
        cache = init_kv_cache(c, B, cache_len, dtype=prefix_embeds.dtype, device=dev,
                              num_kv_heads=local_kv_heads(params["layers"], c, tp_group))
    positions = (torch.cumsum(prefix_mask.int(), dim=1) - 1).clamp(min=0)
    hidden, cache = decoder_forward(
        params, c, prefix_embeds, prefix_mask, positions,
        cache=cache, cache_index=0,
        cache_mask=torch.zeros((B, cache_len), dtype=torch.bool, device=dev),
        impl=impl, tp_group=tp_group,
    )
    cache_mask = torch.nn.functional.pad(prefix_mask.bool(), (0, cache_len - P))
    last_hidden = hidden[:, -1, :]  # content is right-aligned
    next_pos = prefix_mask.int().sum(dim=1)
    return cache, cache_mask, last_hidden, next_pos


def cache_rows(cache, row: int, n: int):
    """Rows [row, row + n) of a cache (batch axis 1 of every leaf), as views
    that write through to it."""
    if isinstance(cache, dict):
        return {k: v[:, row:row + n] for k, v in cache.items()}
    return tuple(v[:, row:row + n] for v in cache)


def merge_cache_rows(big, small, row: int):
    """Write ``small``'s batch rows into ``big`` at batch offset ``row``, in
    place; returns ``big``. Caches are the (k, v) pair or the int8 dict of
    ``init_kv_cache``."""
    dst = cache_rows(big, row, (small["kq"] if isinstance(small, dict) else small[0]).shape[1])
    pairs = zip(dst.values(), small.values()) if isinstance(small, dict) else zip(dst, small)
    for d, s_ in pairs:
        d.copy_(s_)
    return big


def _prefill_into(params, c, big, prefix_embeds, prefix_mask, *, prefill_batch,
                  cache_len, impl="auto", tp_group=None):
    """Prefill ``prefix_embeds`` in sub-batches of ``prefill_batch`` rows, each
    writing its K/V rows straight into the decode-batch cache ``big`` (no
    sub-batch cache, no merge pass). Returns (cache_mask, last_hidden,
    next_pos) of the whole batch.

    The JAX package has two programs for this (a dispatch loop of
    ``prefill_into_jit`` and one ``lax.scan`` executable, chosen by
    ``use_prefill_scan`` and TRACE_TPU_PREFILL_SCAN) that compute the same
    thing; eager PyTorch has one loop, so neither the choice nor its
    variable exists here. Slots of ``big`` beyond the prefix keep what they
    held: a decode step writes a slot before it is visible."""
    B = prefix_embeds.shape[0]
    cms, lhs, nps = [], [], []
    for r in range(0, B, prefill_batch):
        n = min(prefill_batch, B - r)
        _, cm, lh, npos = prefill(
            params, c, prefix_embeds[r:r + n], prefix_mask[r:r + n],
            cache_len=cache_len, impl=impl, cache=cache_rows(big, r, n), tp_group=tp_group)
        cms.append(cm)
        lhs.append(lh)
        nps.append(npos)
    return torch.cat(cms), torch.cat(lhs), torch.cat(nps)


def _decode_from_state(
    params, c, cache, cache_mask, last_hidden, next_pos,
    combined_embed, initial_head, *,
    prefix_len, max_new_tokens, temperature, eos_id,
    constrain_time, frame_time_ids, generator, embed_dtype,
    stop_ids=None, impl="auto", max_steps=None, tp_group=None,
):
    """FSM decode loop from a prefilled cache. Returns (tokens [B, N],
    num_generated [B], decode_steps). N = ``max_new_tokens`` sizes the token
    buffer (and the cache beyond the prefix); ``max_steps`` stops the loop
    earlier, leaving the rest of the buffer PAD_OUTPUT_ID.

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

    logits = lambda hid: compute_logits(params, hid, impl=impl, tp_group=tp_group,
                                        vocab_size=c.vocab_size)
    # first token from the prefill's last hidden state
    tok = pick_token(logits(last_hidden), initial_head, alive, vpos).long()
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

    limit = max_new_tokens if max_steps is None else min(max_new_tokens, max_steps)
    step = 1
    while step < limit and not bool(done.all()):
        cur_embed = combined_embed[tok].to(embed_dtype)
        write_idx = P + step - 1  # slot of the token being fed in
        hidden, cache = decoder_forward(
            params, c, cur_embed[:, None, :], ones,
            (next_pos + step - 1)[:, None],
            cache=cache, cache_index=write_idx, cache_mask=cache_mask, impl=impl,
            tp_group=tp_group,
        )
        cache_mask[:, write_idx] = True
        tok = pick_token(logits(hidden[:, -1, :]), head, alive, vpos).long()

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


def decode(params, config, cache, cache_mask, last_hidden, next_pos, combined_embed,
           initial_head, *, prefix_len: int, max_new_tokens: int,
           temperature: float = 0.0, eos_id: int = 2, seed: int = 0,
           constrain_time: bool = False, frame_time_ids=None, stop_sequences=None,
           max_steps: Optional[int] = None, embed_dtype=None, impl: str = "auto",
           tp_group=None):
    """The decode phase as an entry point of its own (the JAX package's
    ``decode_jit``): the FSM loop from a prefilled cache of ``prefix_len +
    max_new_tokens`` slots whose rows share ``prefix_len``; ``initial_head``
    an int or a [B] tensor; ``max_steps`` stops the loop before
    ``max_new_tokens``. The cache and ``cache_mask`` are updated in place.
    Returns (tokens [B, max_new_tokens], num_generated [B], decode_steps).
    ``embed_dtype`` (the dtype the fed-back token embeddings take) defaults,
    as in ``decode_jit``, to the cache's, or the table's for the int8
    cache. ``tp_group``: tensor-parallel steps, as in ``prefill``."""
    B = last_hidden.shape[0]
    dev = last_hidden.device
    if embed_dtype is None:
        embed_dtype = combined_embed.dtype if isinstance(cache, dict) else cache[0].dtype
    heads = (initial_head.to(dev).long() if torch.is_tensor(initial_head)
             else torch.full((B,), initial_head, dtype=torch.long, device=dev))
    generator = None
    if temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return _decode_from_state(
        params, config, cache, cache_mask, last_hidden, next_pos,
        combined_embed, heads,
        prefix_len=prefix_len, max_new_tokens=max_new_tokens,
        temperature=temperature, eos_id=eos_id,
        constrain_time=constrain_time,
        frame_time_ids=(None if frame_time_ids is None
                        else frame_time_ids.to(dev).long()),
        generator=generator, embed_dtype=embed_dtype,
        stop_ids=pack_stop_sequences(stop_sequences, dev), impl=impl,
        max_steps=max_steps, tp_group=tp_group,
    )


def _pad_to_bucket(prefix_embeds, prefix_mask, pad_to_multiple: int):
    """Left-pad [B, P, D] / [B, P] to the bucket of ``pad_to_multiple``."""
    P = prefix_embeds.shape[1]
    bucket = max(pad_to_multiple, -(-P // pad_to_multiple) * pad_to_multiple)
    if bucket != P:
        pad = bucket - P
        prefix_embeds = torch.nn.functional.pad(prefix_embeds, (0, 0, pad, 0))
        prefix_mask = torch.nn.functional.pad(prefix_mask, (pad, 0))
    return prefix_embeds, prefix_mask.bool(), bucket


def _arena(config, B: int, cache_len: int, dtype, device, cache, num_kv_heads=None):
    """``cache`` when its leaves have the shapes and dtypes of
    ``init_kv_cache(config, B, cache_len, dtype)`` on ``device``, else a new
    cache of those."""
    want = init_kv_cache(config, B, cache_len, dtype=dtype, device="meta",
                         num_kv_heads=num_kv_heads)
    if isinstance(want, dict):
        fits = isinstance(cache, dict) and set(cache) == set(want)
        pairs = [(cache[k], want[k]) for k in want] if fits else []
    else:
        fits = isinstance(cache, tuple) and len(cache) == len(want)
        pairs = list(zip(cache, want)) if fits else []
    if fits and all(a.shape == b.shape and a.dtype == b.dtype and a.device == device
                    for a, b in pairs):
        return cache
    return init_kv_cache(config, B, cache_len, dtype=dtype, device=device,
                         num_kv_heads=num_kv_heads)


def _generate(params, config, prefix_embeds, prefix_mask, combined_embed, *,
              max_new_tokens, budget, initial_head, temperature, eos_id, seed,
              pad_to_multiple, constrain_time, frame_time_ids, stop_sequences,
              impl, prefill_batch=None, cache=None, time_phases=True,
              max_steps=None, tp_group=None) -> GenerateOutput:
    """Bucket, prefill (whole or in sub-batches into one cache), decode."""
    if isinstance(prefix_embeds, list):
        prefix_embeds = prefix_embeds.pop()  # empty the caller's list
    if isinstance(prefix_mask, list):
        prefix_mask = prefix_mask.pop()
    prefix_embeds, prefix_mask, bucket = _pad_to_bucket(
        prefix_embeds, prefix_mask, pad_to_multiple)
    B = prefix_embeds.shape[0]
    dev = prefix_embeds.device
    cache_len = bucket + budget

    kv_heads = local_kv_heads(params["layers"], config, tp_group)
    t0 = time.perf_counter()
    if prefill_batch is None or prefill_batch >= B:
        cache, cache_mask, last_hidden, next_pos = prefill(
            params, config, prefix_embeds, prefix_mask,
            cache_len=cache_len, impl=impl, tp_group=tp_group,
            cache=None if cache is None else _arena(
                config, B, cache_len, prefix_embeds.dtype, dev, cache, kv_heads))
    else:
        cache = _arena(config, B, cache_len, prefix_embeds.dtype, dev, cache, kv_heads)
        cache_mask, last_hidden, next_pos = _prefill_into(
            params, config, cache, prefix_embeds, prefix_mask,
            prefill_batch=prefill_batch, cache_len=cache_len, impl=impl, tp_group=tp_group)
    embed_dtype = prefix_embeds.dtype
    # the prefix (~B*P*D) is dead once prefilled
    del prefix_embeds
    t1 = None
    if time_phases:
        _sync(dev)
        t1 = time.perf_counter()

    tokens, num, steps = decode(
        params, config, cache, cache_mask, last_hidden, next_pos,
        combined_embed, initial_head,
        prefix_len=bucket, max_new_tokens=budget,
        temperature=temperature, eos_id=eos_id, seed=seed,
        constrain_time=constrain_time, frame_time_ids=frame_time_ids,
        stop_sequences=stop_sequences, max_steps=max_steps,
        embed_dtype=embed_dtype, impl=impl, tp_group=tp_group,
    )
    tokens_np = tokens.cpu().numpy()  # waits for the decode loop
    phase_times = None
    if time_phases:
        phase_times = {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}
    return GenerateOutput(tokens=tokens_np, num_generated=num.cpu().numpy(),
                          decode_steps=steps, phase_times=phase_times, cache=cache)


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
    prefill_batch: Optional[int] = None,
    stop_sequences=None,
    impl: str = "auto",
    tp_group=None,
) -> GenerateOutput:
    """Left-pad the prefix to a bucket of ``pad_to_multiple``, prefill a
    static cache of ``bucket + max_new_tokens`` slots, and run the FSM
    decode loop. ``prefill_batch`` < B prefills in sub-batches of that many
    rows, each writing its rows of the one cache. One-element-list prefix
    arguments hand the prefix over (see ``generate_split``).

    ``initial_head`` defaults to 1 (time head): the production prompt ends
    with ``<sync>``. Prefill runs through ``flash_attention`` and each step
    through ``decode_attention`` (their plain versions on the CPU or with
    ``impl="plain"``). Greedy decoding (temperature 0) is token-exact with
    the JAX package at fp32; with temperature > 0 tokens are drawn with
    ``torch.multinomial`` from a ``torch.Generator`` seeded with ``seed``,
    which matches JAX's sampler in distribution, not bit for bit.
    ``tp_group``: tensor-parallel layers on this rank's shards (see
    ``generate_sharded``)."""
    out = _generate(
        params, config, prefix_embeds, prefix_mask, combined_embed,
        max_new_tokens=max_new_tokens, budget=max_new_tokens,
        initial_head=initial_head, temperature=temperature, eos_id=eos_id,
        seed=seed, pad_to_multiple=pad_to_multiple, constrain_time=constrain_time,
        frame_time_ids=frame_time_ids, stop_sequences=stop_sequences, impl=impl,
        prefill_batch=prefill_batch, tp_group=tp_group)
    out.cache = None
    return out


def generate_split(
    params: dict,
    config: DecoderConfig,
    prefix_embeds: torch.Tensor,
    prefix_mask: torch.Tensor,
    combined_embed: torch.Tensor,
    *,
    prefill_batch: int,
    max_new_tokens: int = 1024,
    initial_head: int = 1,
    temperature: float = 0.0,
    eos_id: int = 2,
    seed: int = 0,
    pad_to_multiple: int = 128,
    constrain_time: bool = False,
    frame_time_ids: Optional[torch.Tensor] = None,
    stop_sequences=None,
    cache=None,
    time_phases: bool = False,
    token_budget: Optional[int] = None,
    impl: str = "auto",
) -> GenerateOutput:
    """generate() with the serving-style prefill/decode split: prefill runs
    in ``prefill_batch``-row sub-batches that write their rows of one
    decode-batch cache in place, then one decode loop runs the whole batch.
    Prefill's activation working set (~B*P*D) is what caps the batch of a
    monolithic call; the decode loop's (~B*D) is not.

    ``prefix_embeds`` / ``prefix_mask`` may be one-element lists: the list
    is emptied (ownership transfer), so the prefix is freed once prefilled
    rather than held by the caller through the decode loop.

    ``cache``: a KV arena (``init_kv_cache`` shapes) to reuse; it comes back
    on ``GenerateOutput.cache`` for the next call. A cache of other shapes is
    dropped and a new one made.

    ``token_budget`` > ``max_new_tokens`` sizes the cache and the token
    buffer ([B, token_budget]) for the larger budget while the loop stops
    after ``max_new_tokens`` tokens (PAD_OUTPUT_ID beyond), so runs of
    several lengths share one arena. ``time_phases`` ends the prefill with
    a device sync and fills ``phase_times``."""
    budget = max(max_new_tokens, token_budget or 0)
    return _generate(
        params, config, prefix_embeds, prefix_mask, combined_embed,
        max_new_tokens=max_new_tokens, budget=budget,
        initial_head=initial_head, temperature=temperature, eos_id=eos_id,
        seed=seed, pad_to_multiple=pad_to_multiple, constrain_time=constrain_time,
        frame_time_ids=frame_time_ids, stop_sequences=stop_sequences, impl=impl,
        prefill_batch=prefill_batch, cache=cache, time_phases=time_phases,
        max_steps=max_new_tokens if token_budget else None)


def generate_sharded(
    params: dict,
    config: DecoderConfig,
    prefix_embeds: torch.Tensor,
    prefix_mask: torch.Tensor,
    combined_embed: torch.Tensor,
    *,
    mesh,
    **kw,
) -> GenerateOutput:
    """Generation over a mesh (``runtime/mesh.py``): the batch over 'data',
    the decoder tensor-parallel over 'model'.

    Every rank of the mesh calls it with the same global prefix [B, P, D],
    mask and combined table (whole), and ``params`` placed by
    ``shard_params_for_inference`` (this rank's shards). A rank generates
    the rows of its 'data' share, its layers running on its shards with the
    'model' group's collectives (``decoder_forward``'s ``tp_group``: the
    products column- and row-parallel, the KV cache holding the rank's kv
    heads, the vocab-sharded ``lm_head`` gathered before the head FSM); the
    rows are gathered over 'data' at the end, so every rank returns the
    whole batch's tokens, as JAX's global array holds them. ``kw`` are
    ``generate``'s; ``decode_steps`` is the largest over the 'data' shares.

    The JAX package turns its Pallas kernels off here, because GSPMD cannot
    partition a custom call; each rank here runs the hand-written kernels at
    its local shapes. The native int4 tree (``int4_serving``, marked by
    ``config.native_int4``) runs on each rank's per-channel packed shards,
    packed on the rank by ``shard_params_for_inference``, through the packed
    product kernel at the local shapes. Any other packed tree (int4p)
    raises ``ValueError`` with the JAX package's text, which names the
    formats that shard (int8, int4): it is a single-device serving
    format."""
    import torch.distributed as dist

    from trace_tpu_torch.model.quantize import is_packed4, packed4_groups
    from trace_tpu_torch.parallel.collectives import all_reduce, gather

    if any(is_packed4(l) and (not config.native_int4 or packed4_groups(l) > 1)
           for l in params.get("layers", {}).values()):
        raise ValueError(
            "int4p (nibble-packed) weights are single-chip only; use "
            "quant='int8' or 'int4' for sharded generation"
        )
    B = prefix_embeds.shape[0]
    dn, di = mesh.shape["data"], mesh.coord("data")
    if B % dn:
        raise ValueError(f"batch {B} does not divide over 'data' ({dn})")
    rows = slice(di * (B // dn), (di + 1) * (B // dn))
    dev = mesh.device
    ft = kw.get("frame_time_ids")
    if ft is not None:
        kw["frame_time_ids"] = ft[rows].to(dev)
    out = generate(params, config, prefix_embeds[rows].to(dev), prefix_mask[rows].to(dev),
                   combined_embed.to(dev), tp_group=mesh.group("model"), **kw)
    data = mesh.group("data")
    tokens = gather(torch.from_numpy(out.tokens).to(dev), 0, data)
    num = gather(torch.from_numpy(out.num_generated).to(dev), 0, data)
    steps = all_reduce(torch.tensor([out.decode_steps], device=dev), data,
                       op=dist.ReduceOp.MAX)
    return GenerateOutput(tokens=tokens.cpu().numpy(), num_generated=num.cpu().numpy(),
                          decode_steps=int(steps.item()), phase_times=out.phase_times)

