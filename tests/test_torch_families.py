"""The llama / vicuna (MHA) and qwen2 (GQA with q / k / v biases) backbones
of the port against the JAX package's, and the decode attention at any
group size G = H / NKV (qwen2-7B's 28 / 4 heads give G = 7).

- decode attention: the plain versions against the Pallas bodies in
  interpret mode at hd 128, G = 3, 7, 8, 16, with the masks of
  tests/test_torch_kernels.py and its tolerances (bf16 body at bf16 inputs:
  2^-7 relative, 1e-5 absolute; int8 bodies: 5e-4);
- decoders: fp32 hidden states and logits of a prefill and a decode step
  within 1e-5 of JAX's (the same arithmetic summed in other orders), and
  HF's ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` through the port's
  converter within 3e-4 (tests/test_model_families.py's limit for JAX);
- ``trace_config_from_hf`` and ``model_init`` on merged checkpoints written
  here (llama, qwen2 at 4 / 2 heads, qwen2 at 7 / 1 heads, hd 128): the same
  tree and config, and token-exact greedy streams through ``infer_events``
  with the unquantized weights (fp32), int8 and int4p serving (the JAX side
  runs its kernels interpreted, as tests/test_torch_pipeline.py does);
- training: loss and the gradient of every trainable leaf, bq / bk / bv
  included, against ``jax.grad`` under stages sft and pretrain (limits of
  tests/test_torch_train.py).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import (
    assert_trees_equal,
    jax_config,
    tiny_vision,  # noqa: F401  (a fixture)
    write_hf_tokenizer,
    write_merged_checkpoint,
)
from test_torch_train import _batch as train_batch
from test_torch_train import _assert_grads_match, _jax_loss_and_grads, _torch_loss_and_grads
from trace_tpu.checkpoint import convert as jconvert
from trace_tpu.kernels.decode_attention import decode_attention as jax_decode
from trace_tpu.model import mistral as jm
from trace_tpu.model import trace_model as jtm
from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.runtime import generate as jgen
from trace_tpu.video.io import load_video_frames as jax_load_video
from trace_tpu_torch.checkpoint import convert as tconvert
from trace_tpu_torch.kernels.decode_attention import decode_attention, group_splits
from trace_tpu_torch.model import mistral as tm
from trace_tpu_torch.model.config import DecoderConfig, TraceConfig
from trace_tpu_torch.params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
INT8_TOL = 5e-4
FAMILIES = {
    "llama": dict(num_heads=4, num_kv_heads=4),
    "qwen2": dict(num_heads=4, num_kv_heads=2, attn_qkv_bias=True, rms_eps=1e-6,
                  rope_theta=1000000.0),
}


# ---------------------------------------------------------------------------
# decode attention at any G: plain versions against the Pallas bodies
# ---------------------------------------------------------------------------

def _decode_case(G, seed, L=2, B=3, NKV=2, S=160, HD=128):
    """q, bf16 K / V, the int8 cache quantized by JAX, and a [B, S] bias:
    row 0 sees no slot (every slot then weighs p = 1), row 1 one slot, row
    2 a valid prefix with scattered masked slots."""
    from trace_tpu.model.mistral import _quantize_kv as jax_quantize_kv

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NKV * G, 1, HD)).astype(np.float32)
    kv = [rng.standard_normal((L, B, NKV, S, HD)).astype(np.float32) for _ in range(2)]
    cache = {}
    for (vals, scales), x in zip((("kq", "ks"), ("vq", "vs")), kv):
        xq, xs = jax_quantize_kv(jnp.asarray(x.reshape(L * B, NKV, S, HD)))
        cache[vals] = np.array(xq).reshape(L, B, NKV, S, HD)
        cache[scales] = np.array(xs.astype(jnp.float32)).reshape(L, B, NKV, 1, S)
    visible = (np.arange(S)[None] < 131) & (rng.random((B, S)) < 0.8)
    visible[0] = False
    visible[1] = False
    visible[1, S // 2 + 3] = True
    return q, kv, cache, np.where(visible, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("G", [3, 7, 8, 16])
def test_decode_bf16_plain_matches_pallas_at_any_group(G):
    q, (k, v), _, bias = _decode_case(G, seed=80 + G)
    as_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    qt, kt, vt = as_bf16(q), as_bf16(k), as_bf16(v)
    want = jax_decode(as_jax(qt), (as_jax(kt), as_jax(vt)), jnp.int32(1),
                      jnp.asarray(bias), interpret=True)
    got = decode_attention(qt, kt[1], vt[1], torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("G", [3, 7, 8, 16])
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
def test_decode_int8_plain_matches_pallas_at_any_group(monkeypatch, G, mode):
    """s8dot against the JAX package's default (stacked-chain) body, dequant
    against its TRACE_TPU_DECODE_ATTN_S8=0 body."""
    if mode == "s8dot":
        monkeypatch.delenv("TRACE_TPU_DECODE_ATTN_S8", raising=False)
    else:
        monkeypatch.setenv("TRACE_TPU_DECODE_ATTN_S8", "0")
    q, _, cache, bias = _decode_case(G, seed=90 + G)
    jcache = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in ("ks", "vs") else jnp.int8)
              for k, v in cache.items()}
    want = np.asarray(jax_decode(jnp.asarray(q), jcache, jnp.int32(1), jnp.asarray(bias),
                                 interpret=True))
    stripe = {k: torch.from_numpy(v).to(torch.bfloat16 if k in ("ks", "vs") else torch.int8)[1]
              for k, v in cache.items()}
    got = decode_attention(torch.from_numpy(q), stripe, None, torch.from_numpy(bias),
                           mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=INT8_TOL, atol=INT8_TOL)


def test_group_splits():
    """A launch takes 1 ... 8 query rows a kv head at hd 128 (1, 2 or 4 at
    hd 64); a larger group goes in splits, the largest first."""
    assert group_splits(7, 128) == [(0, 7)]
    assert group_splits(16, 128) == [(0, 8), (8, 8)]
    assert group_splits(12, 128) == [(0, 8), (8, 4)]
    assert group_splits(7, 64) == [(0, 4), (4, 2), (6, 1)]
    assert group_splits(4, 64) == [(0, 4)]


# ---------------------------------------------------------------------------
# the decoders against JAX and against HF
# ---------------------------------------------------------------------------

def _decoders(family, seed=0):
    """JAX and port configs of a tiny decoder of ``family`` and its weights
    (made by JAX; qwen2's biases drawn nonzero, so the bias path counts)."""
    jcfg = dataclasses.replace(JDecoderConfig.tiny(), **FAMILIES[family])
    cfg = dataclasses.replace(DecoderConfig.tiny(), **FAMILIES[family])
    jp = jm.init_decoder_params(jcfg, jax.random.PRNGKey(seed))
    if jcfg.attn_qkv_bias:
        rng = np.random.default_rng(seed)
        layers = dict(jp["layers"])
        for name in ("bq", "bk", "bv"):
            layers[name] = jnp.asarray(
                rng.standard_normal(layers[name].shape).astype(np.float32) * 0.5)
        jp = {**jp, "layers": layers}
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_decode_logits_match_jax(family):
    """Prefill into a static cache (row 1 left-padded), then one T = 1 step:
    hidden states of the real rows and the combined logits of the step."""
    jcfg, cfg, jp, tp = _decoders(family)
    B, T, S = 2, 12, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, :3] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    jh, jcache = jm.decoder_forward(
        jp, jcfg, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos),
        cache=jm.init_kv_cache(jcfg, B, S, dtype=jnp.float32), cache_index=jnp.int32(0),
        cache_mask=jnp.zeros((B, S), bool))
    th, tcache = tm.decoder_forward(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos),
        cache=tm.init_kv_cache(cfg, B, S, dtype=torch.float32), cache_index=0,
        cache_mask=torch.zeros((B, S), dtype=torch.bool))
    real = mask[:, :, None]
    _close(th * torch.from_numpy(real), np.asarray(jh) * real)
    x1 = rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32)
    pos1 = mask.sum(1, keepdims=True).astype(np.int32)
    cmask = np.pad(mask, ((0, 0), (0, S - T)))
    jh1, _ = jm.decoder_forward(
        jp, jcfg, jnp.asarray(x1), jnp.ones((B, 1), bool), jnp.asarray(pos1),
        cache=jcache, cache_index=jnp.int32(T), cache_mask=jnp.asarray(cmask))
    th1, _ = tm.decoder_forward(
        tp, cfg, torch.from_numpy(x1), torch.ones((B, 1), dtype=torch.bool),
        torch.from_numpy(pos1), cache=tcache, cache_index=T,
        cache_mask=torch.from_numpy(cmask))
    _close(th1, jh1)
    _close(tm.compute_logits(tp, th1[:, -1]), jm.compute_logits(jp, jh1[:, -1]), 2e-5)


def _hf_model(family):
    """A tiny HF model of ``family`` from a config (no download), qwen2's
    biases nonzero; and the port's DecoderConfig of it."""
    common = dict(vocab_size=384, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, head_dim=16,
                  max_position_embeddings=256, attention_dropout=0.0,
                  tie_word_embeddings=False)
    if family == "llama":
        from transformers import LlamaConfig, LlamaForCausalLM

        torch.manual_seed(0)
        model = LlamaForCausalLM(LlamaConfig(num_key_value_heads=4, rms_norm_eps=1e-5,
                                             attention_bias=False, **common))
    else:
        from transformers import Qwen2Config, Qwen2ForCausalLM

        torch.manual_seed(1)
        model = Qwen2ForCausalLM(Qwen2Config(num_key_value_heads=2, rms_norm_eps=1e-6,
                                             **common))
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0, 0.1)
    hf = model.config.to_dict()
    cfg = tconvert.trace_config_from_hf({**hf, "model_type": family}).decoder
    return model.eval(), dataclasses.replace(cfg, time_vocab_size=13, score_vocab_size=13)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_parity(family):
    """HF's logits of 2 x 9 random ids against the port's converter,
    decoder and text head on the same state dict."""
    model, cfg = _hf_model(family)
    assert cfg.attn_qkv_bias == (family == "qwen2")
    params = tconvert.convert_mistral_decoder(model.state_dict(), cfg, dtype=torch.float32)
    B, T = 2, 9
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)))
    with torch.no_grad():
        want = model(ids).logits.numpy()
        hidden, _ = tm.decoder_forward(params, cfg, params["embed"][ids],
                                       torch.ones((B, T), dtype=torch.bool),
                                       torch.arange(T)[None].expand(B, T))
        got = tm.compute_logits(params, hidden)[..., :cfg.vocab_size].numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_trace_config_from_hf_matches_jax():
    """qwen2 sets the qkv biases; a llama config without
    ``num_key_value_heads`` takes 8 KV heads on both sides (HF's llama
    would take ``num_attention_heads``: a difference both packages pin); a
    mixtral one gives JAX's MoE config."""
    base = {"hidden_size": 256, "num_attention_heads": 16, "intermediate_size": 512,
            "num_hidden_layers": 2, "vocab_size": 1000}
    for hf in ({**base, "model_type": "qwen2", "num_key_value_heads": 4,
                "rope_theta": 1e6, "rms_norm_eps": 1e-6},
               {**base, "model_type": "llama"}):
        want = jconvert.trace_config_from_hf(hf).decoder
        got = tconvert.trace_config_from_hf(hf).decoder
        for f in dataclasses.fields(got):
            if hasattr(want, f.name):
                assert getattr(got, f.name) == getattr(want, f.name), (hf["model_type"], f.name)
    assert tconvert.trace_config_from_hf({**base, "model_type": "qwen2"}).decoder.attn_qkv_bias
    assert tconvert.trace_config_from_hf({**base, "model_type": "llama"}).decoder.num_kv_heads == 8
    mixtral = {**base, "model_type": "mixtral", "num_local_experts": 4,
               "num_experts_per_tok": 2}
    want = jconvert.trace_config_from_hf(mixtral).decoder
    got = tconvert.trace_config_from_hf(mixtral).decoder
    assert type(got).__name__ == type(want).__name__ == "MoEConfig"
    for f in dataclasses.fields(got):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), ("mixtral", f.name)


# ---------------------------------------------------------------------------
# model_init on merged checkpoints of each family, served through
# infer_events on both sides
# ---------------------------------------------------------------------------

ASK = "Localize a series of activity events in the video ."
CHECKPOINTS = {  # decoder widths (hd 128, the JAX int8 decode kernel's) and model_type
    "llama": (dict(num_heads=2, num_kv_heads=2), "llama"),
    "qwen2": (dict(num_heads=4, num_kv_heads=2, attn_qkv_bias=True, rms_eps=1e-6), "qwen2"),
    "qwen2_g7": (dict(num_heads=7, num_kv_heads=1, attn_qkv_bias=True), "qwen2"),
}


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """One merged checkpoint dir per entry of CHECKPOINTS (bias values
    0.02 N(0, 1), as every bias of the writer), with a word-level tokenizer
    and a 10-frame ``.npy`` video."""
    dirs = {}
    for name, (widths, model_type) in CHECKPOINTS.items():
        cfg = jax_config(decoder=dict(num_layers=2, head_dim=128, hidden_size=256,
                                      intermediate_size=256, **widths))
        path = tmp_path_factory.mktemp(name)
        write_merged_checkpoint(path, cfg, seed=31, shards=2)
        hf = json.loads((path / "config.json").read_text())
        (path / "config.json").write_text(json.dumps({**hf, "model_type": model_type}))
        write_hf_tokenizer(path, cfg.decoder.vocab_size)
        rng = np.random.default_rng(32)
        np.save(path / "video.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))
        dirs[name] = path
    return dirs


@pytest.fixture
def jax_serving_kernels_interpreted(monkeypatch):
    from trace_tpu.kernels import flash_attention as jfa

    monkeypatch.setenv("TRACE_TPU_DECODE_ATTN", "force")
    for name in ("TRACE_TPU_DECODE_ATTN_S8", "TRACE_TPU_STACKED_QMM", "TRACE_TPU_QMM"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jgen, "default_use_flash", lambda: True)
    monkeypatch.setattr(
        jfa, "flash_attention_trainable",
        lambda q, k, v, bias, causal=False: jfa.flash_attention(
            q, k, v, bias, causal=causal, interpret=True))


@pytest.mark.parametrize("name,quant", [
    ("llama", "bf16"), ("llama", "int8"), ("llama", "int4p"),
    ("qwen2", "bf16"), ("qwen2", "int8"), ("qwen2", "int4p"),
    ("qwen2_g7", "bf16"), ("qwen2_g7", "int8"),
])
def test_model_init_matches_jax(ckpt_dirs, tiny_vision, jax_serving_kernels_interpreted,
                                name, quant):
    """The same converted (and host-quantized) tree and config, and the same
    greedy events and tokens from ``infer_events``. A biased tree stays
    unfused (its int8 / int4p leaves run one product per weight)."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    path = ckpt_dirs[name]
    jpipe = jax_model_init(str(path), dtype=jnp.float32, quant=quant)
    tpipe = model_init(str(path), dtype=torch.float32, quant=quant, device="cpu")
    jpipe._prepare_memory_layout()
    assert_trees_equal(tpipe.params, jpipe.params)
    dec = tpipe.config.decoder
    for f in dataclasses.fields(dec):
        if hasattr(jpipe.config.decoder, f.name):
            assert getattr(dec, f.name) == getattr(jpipe.config.decoder, f.name), f.name
    assert dec.attn_qkv_bias == name.startswith("qwen2")
    assert dec.num_heads // dec.num_kv_heads == {"llama": 1, "qwen2": 2, "qwen2_g7": 7}[name]
    fused = "wqkv" in tpipe._decoder_params["layers"]
    assert fused == (quant != "bf16" and not dec.attn_qkv_bias)

    video = str(path / "video.npy")
    want = jpipe.infer_events(video, ASK, max_new_tokens=16)
    got = tpipe.infer_events(video, ASK, max_new_tokens=16)
    assert got.to_dict() == want.to_dict()
    frames, ts = jax_load_video(video, jpipe.config.num_frames)
    jprefix, jmask = jpipe._prepare_prefix_batch([frames], [ts], [ASK])
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=16, initial_head=1,
                         eos_id=jpipe.tokenizer.eos_token_id, use_flash=True)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0


@pytest.mark.parametrize("template", ["qwen", "vicuna_v1"])
def test_family_templates_match_jax(ckpt_dirs, tiny_vision, jax_serving_kernels_interpreted,
                                    template):
    """``infer_text`` with the qwen (stop string <|im_end|>) and vicuna_v1
    (###) templates: the same prompt, stop handling and text as JAX's."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    path = ckpt_dirs["qwen2"]
    jpipe = jax_model_init(str(path), dtype=jnp.float32, quant="bf16")
    tpipe = model_init(str(path), dtype=torch.float32, quant="bf16", device="cpu")
    frames, ts = jax_load_video(str(path / "video.npy"), jpipe.config.num_frames)
    want = jpipe.infer_text(frames, ts, "What is shown ?", max_new_tokens=12,
                            template=template)
    got = tpipe.infer_text(frames, ts, "What is shown ?", max_new_tokens=12,
                           template=template)
    assert got == want


def test_qwen2_corpus_split_matches_jax(ckpt_dirs, tiny_vision, jax_serving_kernels_interpreted):
    """``infer_events_corpus`` in split mode (prefixes into per-chunk stores,
    one reused arena) on the qwen2 checkpoint at G = 7: the events of
    the JAX package's."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    path = ckpt_dirs["qwen2_g7"]
    jpipe = jax_model_init(str(path), dtype=jnp.float32, quant="bf16")
    tpipe = model_init(str(path), dtype=torch.float32, quant="bf16", device="cpu")
    T = jpipe.config.num_frames
    rng = np.random.default_rng(33)
    items = [(rng.integers(0, 255, (T, 56, 56, 3), dtype=np.uint8),
              [[float(2 * i + k)] for i in range(T)], f"{ASK} {k}") for k in range(4)]
    kw = dict(encode_batch=2, decode_batch=4, prefill_batch=2, max_new_tokens=12)
    got = tpipe.infer_events_corpus(lambda i: items[i], 4, **kw)
    want = jpipe.infer_events_corpus(lambda i: items[i], 4, **kw)
    assert [p.to_dict() for p in got] == [p.to_dict() for p in want]


# ---------------------------------------------------------------------------
# training: qwen2's biases take JAX's gradients under each stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["sft", "pretrain"])
def test_qkv_bias_gradients_match_jax(stage):
    """The tiny TRACE on a qwen2 decoder (biases N(0, 0.1), as
    tests/test_model_families.py draws them): the loss and the gradient of
    every trainable leaf against ``jax.grad``; sft trains the biases with
    the backbone, pretrain freezes both."""
    wide = dict(attn_qkv_bias=True, rms_eps=1e-6)
    jcfg = dataclasses.replace(JTraceConfig.tiny(), decoder=dataclasses.replace(
        JDecoderConfig.tiny(), **wide))
    cfg = dataclasses.replace(TraceConfig.tiny(), decoder=dataclasses.replace(
        DecoderConfig.tiny(), **wide))
    jp = jtm.init_trace_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    layers = dict(jp["decoder"]["layers"])
    for name in ("bq", "bk", "bv"):
        layers[name] = jnp.asarray(rng.standard_normal(layers[name].shape).astype(np.float32)
                                   * 0.1)
    jp = {**jp, "decoder": {**jp["decoder"], "layers": layers}}
    batch = train_batch()
    jloss, _, jgrads = _jax_loss_and_grads(jp, jcfg, batch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    tloss, _, tgrads = _torch_loss_and_grads(tp, cfg, batch, stage, remat=True)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    _assert_grads_match(tgrads, jgrads, stage)
    for name in ("bq", "bk", "bv"):
        g = tgrads[f"decoder/layers/{name}"]
        assert (g is None) == (stage == "pretrain")
        assert g is None or g.abs().max() > 0
