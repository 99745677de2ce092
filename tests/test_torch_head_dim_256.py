"""Head dims above 128: the serving rows at Falcon3's head dim 256 and on
copies padded to 256 at 129-255, against the JAX package, which pads hd to a
multiple of 128 in its Pallas attention and sends decode at hd 256 to its
Pallas decode kernel.

- Rows 1 and 8 (the bf16 forward, built at 64, 128 and 256) at hd 160, 200
  and 256: the operands zero-padded to the width ``kernel_width`` gives
  (256), the plain versions run there with the real hd's scale, the output
  sliced back; o and lse held to JAX's ``flash_attention`` and
  ``flash_attention_fwd_res`` in interpret mode, as
  tests/test_torch_head_dims.py holds them at hd 100 (2e-5: other summation
  orders and exp implementations); the padded columns exactly 0. Row 2
  (the ViT, the same instance through a 3-D map) likewise at hd 160 and 256.
- Rows 9 and 10 (the bf16 backward, built at 64, 128 and 256) at hd 160,
  200 and 256: delta, dq, dk and dv of the plain versions on operands padded
  to 256 with hd's scale, sliced, and of the port's wrappers at hd, held to
  JAX's ``flash_attention_bwd`` in interpret mode (2e-4, as at hd 100); the
  padded columns of the gradients exactly 0.
- A training step of a narrow hd-256 model (two query heads of 256, one kv
  head, two layers; the rest ``TraceConfig.tiny()``): in ``sft`` and
  ``lora`` the loss and every trainable leaf's gradient from
  ``forward_train`` against ``jax.grad`` of the JAX package's, with the
  batch, route and tolerances of tests/test_torch_train.py.
- Rows 3 and 3b: the plain decode versions (bf16 cache; int8 cache in both
  modes) at hd 256 against JAX's Pallas decode bodies in interpret mode,
  with the masks and tolerances of tests/test_torch_families.py (bf16 body:
  2^-7 relative, 1e-5 absolute; int8 bodies: 5e-4), dequant with the slack
  of the weights' bf16 rounding, which JAX's CPU run of its body skips (see
  the test).
- ``trace_config_from_hf`` on Falcon3-7B's config.json (hidden 3072, 12 / 4
  heads, head_dim 256) equal in both packages.
- ``model_init`` of a narrow hd-256 llama (two query heads of 256, one kv
  head, two layers) from a checkpoint written here, token-exact with JAX's
  through ``infer_events`` in bf16 and int8 serving (the JAX side runs its
  kernels interpreted, as tests/test_torch_families.py does).
"""

import dataclasses
import json

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
from test_torch_families import ASK, INT8_TOL, jax_serving_kernels_interpreted  # noqa: F401
from test_torch_head_dims import FWD_TOL, GRAD_TOL, _inputs, _padded
from test_torch_train import (
    CFG,
    JCFG,
    LORA_TARGETS,
    _assert_grads_match,
    _jax_loss_and_grads,
    _torch_loss_and_grads,
    _torch_params,
    _with_lora,
    batch,  # noqa: F401  (a fixture)
)
from trace_tpu.checkpoint import convert as jconvert
from trace_tpu.kernels import flash_backward as jfb
from trace_tpu.kernels.decode_attention import decode_attention as jax_decode
from trace_tpu.kernels.flash_attention import flash_attention as j_flash
from trace_tpu.kernels.flash_attention import vit_attention_btd_reference as j_vit
from trace_tpu.runtime import generate as jgen
from trace_tpu.video.io import load_video_frames as jax_load_video
from trace_tpu_torch.checkpoint import convert as tconvert
from trace_tpu_torch.kernels import flash_backward as tfb
from trace_tpu_torch.kernels.decode_attention import decode_attention, group_splits
from trace_tpu_torch.kernels.flash_attention import (
    flash_attention,
    head_dim_limit,
    kernel_width,
    pad_head_dim,
    pad_heads,
    unpad_heads,
    vit_attention_btd,
    vit_attention_btd_reference,
    xla_attention,
)

HEAD_DIMS = (160, 200, 256)


@pytest.mark.parametrize("hd", [132, 160, 200, 252, 256])
def test_kernel_width_above_128(hd):
    """hd 129-256 runs at width 256 in the bf16 forward and backward; the
    fp32 forms stop at 128."""
    assert head_dim_limit() == 256 and head_dim_limit(torch.float32) == 128
    assert kernel_width(hd) == kernel_width(hd, backward=True) == 256
    x = torch.randn(2, 3, hd)
    p = pad_head_dim(x, 256)
    assert p.shape == (2, 3, 256) and torch.equal(p[..., :hd], x) and not p[..., hd:].any()
    assert pad_head_dim(p, 256) is p
    assert group_splits(3, hd) == [(0, 3)] and group_splits(12, hd) == [(0, 8), (8, 4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_forward_above_128_matches_jax(hd, causal):
    """Row 1: the plain attention at width 256 with hd's scale, sliced,
    against JAX's Pallas ``flash_attention`` (which pads hd to 256 itself)
    and the port's own plain version at hd."""
    q, k, v, bias, _ = _inputs(hd, seed=hd)
    want = np.asarray(j_flash(q, k, v, bias, causal=causal, interpret=True))
    qp, kp, vp = _padded(hd, q, k, v)
    assert qp.shape[-1] == 256
    o = xla_attention(qp, kp, vp, torch.from_numpy(bias), causal=causal, scale=hd ** -0.5)
    assert not o[..., hd:].any()
    np.testing.assert_allclose(o[..., :hd].numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    tq, tk, tv, tb = (torch.from_numpy(x) for x in (q, k, v, bias))
    np.testing.assert_allclose(flash_attention(tq, tk, tv, tb, causal).numpy(), want,
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_residuals_above_128_match_jax(hd):
    """Row 8: o and lse of the padded forward (width 256, hd's scale), and of
    the port's wrapper at hd, against JAX's ``flash_attention_fwd_res`` in
    interpret mode; the padded columns of o are 0."""
    q, k, v, bias, _ = _inputs(hd, seed=300 + hd)
    jo, jlse = jfb.flash_attention_fwd_res(q, k, v, bias, causal=True, interpret=True)
    tb = torch.from_numpy(bias)
    qp, kp, vp = _padded(hd, q, k, v)
    o, lse = tfb.flash_attention_fwd_res_plain(qp, kp, vp, tb, causal=True, scale=hd ** -0.5)
    assert not o[..., hd:].any()
    np.testing.assert_allclose(o[..., :hd].numpy(), np.asarray(jo), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=FWD_TOL, atol=FWD_TOL)
    got_o, got_lse = tfb.flash_attention_fwd_res(*(torch.from_numpy(x) for x in (q, k, v)), tb,
                                                 causal=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(jo), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(jlse), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_backward_above_128_matches_jax(hd):
    """Rows 9 and 10: delta, dq and dk / dv of the plain versions on q, k, v,
    o and do padded to the backward's width (256) at hd's scale, sliced, and
    of the port's wrappers at hd, against JAX's ``flash_attention_bwd`` in
    interpret mode (which pads hd to 256 itself); the padded columns of
    every gradient are 0 and delta equals the unpadded one's."""
    q, k, v, bias, do = _inputs(hd, seed=400 + hd)
    jo, jlse = jfb.flash_attention_fwd_res(q, k, v, bias, causal=True, interpret=True)
    jgrads = jfb.flash_attention_bwd(q, k, v, bias, jo, jlse, do, causal=True, interpret=True)

    assert kernel_width(hd, backward=True) == 256
    scale = hd ** -0.5
    tb = torch.from_numpy(bias)
    qp, kp, vp, dop = _padded(hd, q, k, v, do)
    o, lse = tfb.flash_attention_fwd_res_plain(qp, kp, vp, tb, causal=True, scale=scale)
    delta = tfb.flash_attention_bwd_delta(o, dop)
    torch.testing.assert_close(delta, tfb.flash_attention_bwd_delta(o[..., :hd], dop[..., :hd]),
                               rtol=1e-6, atol=1e-6)
    dq = tfb.flash_attention_bwd_dq_plain(qp, kp, vp, tb, dop, lse, delta, causal=True,
                                          scale=scale)
    dk, dv = tfb.flash_attention_bwd_dkv_plain(qp, kp, vp, tb, dop, lse, delta, causal=True,
                                               scale=scale)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    wrapped = tfb.flash_attention_bwd(tq, tk, tv, tb, o[..., :hd].contiguous(), lse, tdo,
                                      causal=True)
    for got, at_hd, want, name in zip((dq, dk, dv), wrapped, jgrads, ("dq", "dk", "dv")):
        assert not got[..., hd:].any(), name
        np.testing.assert_allclose(got[..., :hd].numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
        assert at_hd.shape[-1] == hd, name
        np.testing.assert_allclose(at_hd.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("hd", [160, 256])
def test_vit_attention_above_128_matches_jax(hd):
    """Row 2 (the bf16 forward's instance through the ViT's 3-D map): each
    head's columns padded to 256, the plain version there with hd's scale,
    sliced back, against JAX's reference."""
    NH, P, TQ = 2, 40, 33
    rng = np.random.default_rng(hd)
    qkv = (rng.standard_normal((2, P, 3 * NH * hd)) * 0.5).astype(np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    want = np.asarray(j_vit(q, k, v, tq=TQ, num_heads=NH))
    tq_, tk_, tv_ = torch.from_numpy(qkv).split(NH * hd, dim=-1)
    padded = [pad_heads(x, NH, kernel_width(hd)) for x in (tq_, tk_, tv_)]
    assert all(x.shape == (2, P, NH * 256) for x in padded)
    o = vit_attention_btd_reference(*padded, tq=TQ, num_heads=NH, scale=hd ** -0.5)
    got = unpad_heads(o, NH, hd)
    np.testing.assert_allclose(got[:, :TQ].numpy(), want[:, :TQ], rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(vit_attention_btd(tq_, tk_, tv_, TQ, NH)[:, :TQ].numpy(),
                               want[:, :TQ], rtol=FWD_TOL, atol=FWD_TOL)


def _decode_case(G, seed, L=2, B=3, NKV=2, S=160, HD=256):
    """tests/test_torch_families.py's decode case at hd 256: q, bf16 K / V,
    the int8 cache quantized by JAX, a [B, S] bias (row 0 sees no slot, row
    1 one slot, row 2 a valid prefix with scattered masked slots)."""
    from test_torch_families import _decode_case as families_case

    return families_case(G, seed, L=L, B=B, NKV=NKV, S=S, HD=HD)


@pytest.mark.parametrize("G", [1, 3, 4, 8])
def test_decode_bf16_plain_matches_pallas_at_hd256(G):
    q, (k, v), _, bias = _decode_case(G, seed=180 + G)
    as_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    qt, kt, vt = as_bf16(q), as_bf16(k), as_bf16(v)
    want = jax_decode(as_jax(qt), (as_jax(kt), as_jax(vt)), jnp.int32(1),
                      jnp.asarray(bias), interpret=True)
    got = decode_attention(qt, kt[1], vt[1], torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("mode", ["s8dot", "dequant"])
def test_decode_int8_plain_matches_pallas_at_hd256(monkeypatch, G, mode):
    """s8dot against the JAX package's default (stacked-chain) body, dequant
    against its TRACE_TPU_DECODE_ATTN_S8=0 body. That body rounds the weights
    bf16(p) * vs to bf16 before P.V, as the port does, but run on the CPU
    XLA keeps the fused product in fp32 (unrounded, its output is within
    ~1e-7 of an fp64 sum; at hd 128 as at 256), so a dequant output may
    differ by up to 2^-9 of sum |w| |v| / l beside INT8_TOL."""
    if mode == "s8dot":
        monkeypatch.delenv("TRACE_TPU_DECODE_ATTN_S8", raising=False)
    else:
        monkeypatch.setenv("TRACE_TPU_DECODE_ATTN_S8", "0")
    q, _, cache, bias = _decode_case(G, seed=190 + G)
    jcache = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in ("ks", "vs") else jnp.int8)
              for k, v in cache.items()}
    want = np.asarray(jax_decode(jnp.asarray(q), jcache, jnp.int32(1), jnp.asarray(bias),
                                 interpret=True))
    stripe = {k: torch.from_numpy(v).to(torch.bfloat16 if k in ("ks", "vs") else torch.int8)[1]
              for k, v in cache.items()}
    got = decode_attention(torch.from_numpy(q), stripe, None, torch.from_numpy(bias),
                           mode=mode).numpy()
    slack = 0.0
    if mode == "dequant":  # the weights' bf16 rounding, which JAX's CPU run skips
        B, H, _, hd = q.shape
        NKV = stripe["kq"].shape[1]
        qb = torch.from_numpy(q).to(torch.bfloat16).double().reshape(B, NKV, H // NKV, hd)
        s = (torch.einsum("bngh,bnsh->bngs", qb, stripe["kq"].double())
             * stripe["ks"].double() * hd ** -0.5 + torch.from_numpy(bias).double()[:, None, None])
        p = torch.exp(s - s.amax(-1, keepdim=True))
        w = p.to(torch.bfloat16).double() * stripe["vs"].double()
        slack = (2 ** -9 * torch.einsum("bngs,bnsh->bngh", w, stripe["vq"].double().abs())
                 / p.sum(-1, keepdim=True)).reshape(got.shape).numpy()
    assert (np.abs(got - want) <= INT8_TOL + INT8_TOL * np.abs(want) + slack).all()


# ---------------------------------------------------------------------------
# Falcon3-7B's configuration, and a narrow hd-256 llama served end to end
# ---------------------------------------------------------------------------

# tiiuae/Falcon3-7B-Base config.json (its decoder fields): a LlamaForCausalLM
# checkpoint with head_dim 256 written out (hidden 3072 / 12 heads is 256 too)
FALCON3_7B = {"model_type": "llama", "hidden_size": 3072, "intermediate_size": 23040,
              "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 4,
              "head_dim": 256, "vocab_size": 131072, "rms_norm_eps": 1e-6,
              "rope_theta": 1000042.0}


def test_falcon3_7b_config_matches_jax():
    want = jconvert.trace_config_from_hf(FALCON3_7B).decoder
    got = tconvert.trace_config_from_hf(FALCON3_7B).decoder
    for f in dataclasses.fields(got):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.head_dim, got.hidden_size, got.num_heads, got.num_kv_heads,
            got.intermediate_size) == (256, 3072, 12, 4, 23040)
    assert (got.rope_theta, got.rms_eps, got.vocab_size) == (1000042.0, 1e-6, 131072)


@pytest.fixture(scope="module")
def hd256_ckpt(tmp_path_factory):
    """A merged llama checkpoint at hd 256 (hidden 512, 2 query heads, 1 kv
    head, 2 layers), a word-level tokenizer and a 10-frame ``.npy`` video."""
    cfg = jax_config(decoder=dict(num_layers=2, head_dim=256, hidden_size=512,
                                  intermediate_size=640, num_heads=2, num_kv_heads=1))
    path = tmp_path_factory.mktemp("llama_hd256")
    write_merged_checkpoint(path, cfg, seed=51, shards=2)
    hf = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({**hf, "model_type": "llama"}))
    write_hf_tokenizer(path, cfg.decoder.vocab_size)
    rng = np.random.default_rng(52)
    np.save(path / "video.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))
    return path


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_hd256_model_init_matches_jax(hd256_ckpt, tiny_vision, jax_serving_kernels_interpreted,
                                      quant):
    """The same converted tree and config at hd 256, and the same greedy
    events and tokens from ``infer_events``."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    jpipe = jax_model_init(str(hd256_ckpt), dtype=jnp.float32, quant=quant)
    tpipe = model_init(str(hd256_ckpt), dtype=torch.float32, quant=quant, device="cpu")
    jpipe._prepare_memory_layout()
    assert_trees_equal(tpipe.params, jpipe.params)
    dec = tpipe.config.decoder
    assert dec.head_dim == 256 and (dec.num_heads, dec.num_kv_heads) == (2, 1)
    for f in dataclasses.fields(dec):
        if hasattr(jpipe.config.decoder, f.name):
            assert getattr(dec, f.name) == getattr(jpipe.config.decoder, f.name), f.name

    video = str(hd256_ckpt / "video.npy")
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


# ---------------------------------------------------------------------------
# A training step at hd 256
# ---------------------------------------------------------------------------

def _hd256(cfg):
    """cfg with a narrow hd-256 decoder: two query heads of 256, one kv head."""
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, num_heads=2, num_kv_heads=1, head_dim=256))


@pytest.fixture(scope="module")
def hd256_train_params():
    """stage -> JAX params of the hd-256 tiny model; 'lora' adds adapters on
    the seven projections whose B is random too (as tests/test_torch_train.py
    makes them), so that both adapter leaves take a gradient."""
    import jax

    from trace_tpu.model import lora as jlora
    from trace_tpu.model import trace_model as jtm

    base = jtm.init_trace_params(_hd256(JCFG), jax.random.PRNGKey(7))
    lora = dict(base)
    lora["decoder"] = jlora.add_lora_params(base["decoder"], _with_lora(_hd256(JCFG)).decoder,
                                            jax.random.PRNGKey(8), targets=LORA_TARGETS)
    rng = np.random.default_rng(9)
    layers = dict(lora["decoder"]["layers"])
    for name, leaf in layers.items():
        if name.endswith("_lora_b"):
            layers[name] = jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.05)
    lora["decoder"] = {**lora["decoder"], "layers": layers}
    return {"sft": base, "lora": lora}


@pytest.mark.parametrize("stage", ["sft", "lora"])
def test_hd256_forward_train_loss_and_grads_match_jax(hd256_train_params, batch, stage):
    """The loss, its three streams and every trainable leaf's gradient of an
    hd-256 model's ``forward_train`` against ``jax.grad`` (the JAX side
    without its Pallas flash path, as in tests/test_torch_train.py)."""
    jcfg, cfg = _hd256(JCFG), _hd256(CFG)
    if stage == "lora":
        jcfg, cfg = _with_lora(jcfg), _with_lora(cfg)
    assert cfg.decoder.head_dim == 256 and cfg.decoder.num_heads == 2
    jp = hd256_train_params[stage]
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, jcfg, batch)
    tloss, tmetrics, tgrads = _torch_loss_and_grads(_torch_params(jp), cfg, batch, stage)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    for name in ("text_loss", "time_loss", "score_loss"):
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]),
                                   rtol=1e-5, atol=1e-5)
    _assert_grads_match(tgrads, jgrads, stage)
