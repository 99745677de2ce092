"""Head dims other than the kernels' tile widths (64, 128): the port's
pad-and-slice route against the JAX package, which pads hd to a multiple
of 128 in its Pallas attention and sends decode at such hd to XLA.

- The attention rows (1, 2, 8, 9, 10) at hd 20, 40 and 100: the operands
  zero-padded to the width the CUDA wrappers launch at (``kernel_width``:
  64 or 128), the plain versions run there with the real hd's scale, the
  outputs sliced back; forward, lse and dq / dk / dv held to JAX's
  ``flash_attention``, ``flash_attention_fwd_res`` and
  ``flash_attention_bwd`` in interpret mode, as tests/test_torch_flash_backward.py
  holds them (o and lse 2e-5, gradients 2e-4: other summation orders and
  exp implementations); the padded columns of every output exactly 0.
- The limits the wrappers state: hd above 256 in the bf16 forward, the bf16
  backward and the bf16-query decode, above 128 in every fp32 form (and the
  decode rows' hd not a multiple of 4) raise a ``ValueError`` naming it.
- ``trace_config_from_hf`` on open_llama_3b's config.json (hidden 3200, 32
  heads, hd 100) equal in both packages, with and without
  ``num_key_value_heads``.
- ``model_init`` of a narrow hd-100 llama (hidden 400, 4 heads, 2 layers)
  from a checkpoint written here, token-exact with JAX's through
  ``infer_events`` in bf16 and int8 serving (the JAX side runs its kernels
  interpreted, as tests/test_torch_families.py does).
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
from test_torch_families import ASK, jax_serving_kernels_interpreted  # noqa: F401
from trace_tpu.checkpoint import convert as jconvert
from trace_tpu.kernels import flash_backward as jfb
from trace_tpu.kernels.flash_attention import flash_attention as j_flash
from trace_tpu.kernels.flash_attention import vit_attention_btd_reference as j_vit
from trace_tpu.runtime import generate as jgen
from trace_tpu.video.io import load_video_frames as jax_load_video
from trace_tpu_torch.checkpoint import convert as tconvert
from trace_tpu_torch.kernels import flash_backward as tfb
from trace_tpu_torch.kernels.decode_attention import check_head_dim, group_splits, row_alignment
from trace_tpu_torch.kernels.flash_attention import (
    flash_attention,
    kernel_width,
    pad_head_dim,
    pad_heads,
    unpad_heads,
    vit_attention_btd,
    vit_attention_btd_reference,
    xla_attention,
)

B, H, NKV, T = 2, 4, 2, 160  # GQA, G = 2
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
HEAD_DIMS = (20, 40, 100)


def _inputs(hd, seed):
    """q, k, v, do, a right-padded bias (row 1's last 60 keys masked) and do
    zero on the padded query rows, as the training path gives them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    q, k, v, do = f(B, H, T, hd), f(B, NKV, T, hd), f(B, NKV, T, hd), f(B, H, T, hd) * 2
    valid = np.arange(T)[None, :] < T - np.array([[3], [60]])
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias, do * valid[:, None, :, None]


def _padded(hd, *xs):
    width = kernel_width(hd)
    return [pad_head_dim(torch.from_numpy(x), width) for x in xs]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_width_of_each_head_dim(hd):
    width = kernel_width(hd)
    assert width == (64 if hd <= 64 else 128)
    x = torch.randn(2, 3, hd)
    p = pad_head_dim(x, width)
    assert p.shape == (2, 3, width) and p.is_contiguous()
    assert torch.equal(p[..., :hd], x) and not p[..., hd:].any()
    assert pad_head_dim(p, width) is p


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_padded_forward_matches_jax(hd, causal):
    """Row 1: the plain attention at the padded width with hd's scale, the
    output sliced, against JAX's Pallas ``flash_attention`` (which pads hd
    to 128 itself) and the port's own plain version at hd."""
    q, k, v, bias, _ = _inputs(hd, seed=hd)
    want = np.asarray(j_flash(q, k, v, bias, causal=causal, interpret=True))
    qp, kp, vp = _padded(hd, q, k, v)
    o = xla_attention(qp, kp, vp, torch.from_numpy(bias), causal=causal, scale=hd ** -0.5)
    assert not o[..., hd:].any()
    np.testing.assert_allclose(o[..., :hd].numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    tq, tk, tv, tb = (torch.from_numpy(x) for x in (q, k, v, bias))
    np.testing.assert_allclose(flash_attention(tq, tk, tv, tb, causal).numpy(), want,
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_padded_residuals_and_backward_match_jax(hd):
    """Rows 8-10: o and lse of the padded forward, then delta, dq and dk / dv
    of the padded backward at hd's scale (o and do padded too), sliced,
    against JAX's ``flash_attention_fwd_res`` and ``flash_attention_bwd`` in
    interpret mode; the padded columns of o, dq, dk and dv are 0 and delta
    equals the unpadded one's."""
    q, k, v, bias, do = _inputs(hd, seed=100 + hd)
    jo, jlse = jfb.flash_attention_fwd_res(q, k, v, bias, causal=True, interpret=True)
    jgrads = jfb.flash_attention_bwd(q, k, v, bias, jo, jlse, do, causal=True, interpret=True)

    scale = hd ** -0.5
    tb = torch.from_numpy(bias)
    qp, kp, vp, dop = _padded(hd, q, k, v, do)
    o, lse = tfb.flash_attention_fwd_res_plain(qp, kp, vp, tb, causal=True, scale=scale)
    assert not o[..., hd:].any()
    np.testing.assert_allclose(o[..., :hd].numpy(), np.asarray(jo), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=FWD_TOL, atol=FWD_TOL)

    delta = tfb.flash_attention_bwd_delta(o, dop)
    torch.testing.assert_close(delta, tfb.flash_attention_bwd_delta(o[..., :hd], dop[..., :hd]),
                               rtol=1e-6, atol=1e-6)
    dq = tfb.flash_attention_bwd_dq_plain(qp, kp, vp, tb, dop, lse, delta, causal=True,
                                          scale=scale)
    dk, dv = tfb.flash_attention_bwd_dkv_plain(qp, kp, vp, tb, dop, lse, delta, causal=True,
                                               scale=scale)
    for got, want, name in zip((dq, dk, dv), jgrads, ("dq", "dk", "dv")):
        assert not got[..., hd:].any(), name
        np.testing.assert_allclose(got[..., :hd].numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_padded_vit_attention_matches_jax(hd):
    """Row 2: q, k and v column slices of one fused [B, P, 3D] projection,
    each head's columns padded (``pad_heads``), the plain version at the
    padded width with hd's scale, sliced back (``unpad_heads``), against
    JAX's reference (its Pallas body tiles heads in pairs of hd columns, a
    block width the TPU takes only at multiples of 128)."""
    NH, P, TQ = 3, 40, 33
    rng = np.random.default_rng(hd)
    qkv = (rng.standard_normal((2, P, 3 * NH * hd)) * 0.5).astype(np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    want = np.asarray(j_vit(q, k, v, tq=TQ, num_heads=NH))
    tq_, tk_, tv_ = torch.from_numpy(qkv).split(NH * hd, dim=-1)
    width = kernel_width(hd)
    padded = [pad_heads(x, NH, width) for x in (tq_, tk_, tv_)]
    assert all(x.shape == (2, P, NH * width) for x in padded)
    o = vit_attention_btd_reference(*padded, tq=TQ, num_heads=NH, scale=hd ** -0.5)
    assert not o.unflatten(-1, (NH, width))[..., hd:].any()
    got = unpad_heads(o, NH, hd)
    assert got.shape == (2, P, NH * hd) and got.is_contiguous()
    np.testing.assert_allclose(got[:, :TQ].numpy(), want[:, :TQ], rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(vit_attention_btd(tq_, tk_, tv_, TQ, NH)[:, :TQ].numpy(),
                               want[:, :TQ], rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("family,hd", [
    ("bf16 forward", 0), ("bf16 forward", 257),            # rows 1, 2, 8 in bf16
    ("bf16-query decode", 257), ("bf16-query decode", 512),  # rows 3 / 3b, bf16 q
    ("backward", 129), ("backward", 256), ("backward", 257),  # rows 9-10, bf16 and fp32
    ("fp32", 129), ("fp32", 256),                          # every fp32 form
])
def test_head_dims_past_the_limit_raise(family, hd):
    """Each family of wrappers past its own limit: a ValueError that names
    it (256 for the bf16 forward, the bf16 backward and the bf16-query
    decode, 128 for every fp32 form); the bf16 backward runs hd 129-256 at
    width 256."""
    if family == "bf16 forward":
        with pytest.raises(ValueError, match="forward kernels take 1 ... 256"):
            kernel_width(hd)
    elif family == "bf16-query decode":
        with pytest.raises(ValueError, match="bf16-query .* up to 256"):
            check_head_dim(hd)
    elif family == "backward":
        if hd > 256:
            with pytest.raises(ValueError, match="bf16 .*backward kernels .* take 1 ... 256"):
                kernel_width(hd, torch.bfloat16, backward=True)
        else:
            assert kernel_width(hd, torch.bfloat16, backward=True) == 256
        with pytest.raises(ValueError, match="fp32 .*backward kernels .* take 1 ... 128"):
            kernel_width(hd, torch.float32, backward=True)
    else:
        with pytest.raises(ValueError, match="fp32 attention kernels take 1 ... 128"):
            kernel_width(hd, torch.float32)
        with pytest.raises(ValueError, match="fp32-query .* up to 128"):
            check_head_dim(hd, torch.float32)


@pytest.mark.parametrize("hd,ok", [(64, True), (72, True), (100, True), (128, True),
                                   (4, True), (102, False), (98, False), (3, False)])
def test_decode_head_dims_are_multiples_of_four(hd, ok):
    if ok:
        check_head_dim(hd)
        assert group_splits(7, hd) == ([(0, 7)] if hd > 64 else [(0, 4), (4, 2), (6, 1)])
    else:
        with pytest.raises(ValueError, match="multiples of 4"):
            check_head_dim(hd)


@pytest.mark.parametrize("row_bytes,align", [(256, 16), (200, 8), (100, 4), (400, 16),
                                             (144, 16), (40, 8)])
def test_row_alignment(row_bytes, align):
    assert row_alignment(row_bytes) == align


# ---------------------------------------------------------------------------
# open_llama_3b's configuration, and a narrow hd-100 llama served end to end
# ---------------------------------------------------------------------------

# openlm-research/open_llama_3b config.json (its decoder fields); the
# published file has no num_key_value_heads
OPEN_LLAMA_3B = {"model_type": "llama", "hidden_size": 3200, "intermediate_size": 8640,
                 "num_hidden_layers": 26, "num_attention_heads": 32, "vocab_size": 32000,
                 "rms_norm_eps": 1e-6, "rope_theta": 10000.0}


@pytest.mark.parametrize("kv_heads", [32, None])
def test_open_llama_3b_config_matches_jax(kv_heads):
    """hd 100 from hidden / heads in both packages; without
    ``num_key_value_heads`` both take 8 KV heads (G = 4), with it 32."""
    hf = dict(OPEN_LLAMA_3B)
    if kv_heads is not None:
        hf["num_key_value_heads"] = kv_heads
    want = jconvert.trace_config_from_hf(hf).decoder
    got = tconvert.trace_config_from_hf(hf).decoder
    for f in dataclasses.fields(got):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.head_dim, got.hidden_size, got.intermediate_size) == (100, 3200, 8640)
    assert got.num_kv_heads == (kv_heads or 8)


@pytest.fixture(scope="module")
def hd100_ckpt(tmp_path_factory):
    """A merged llama checkpoint at hd 100 (hidden 400, 4 / 4 heads, 2
    layers), a word-level tokenizer and a 10-frame ``.npy`` video."""
    cfg = jax_config(decoder=dict(num_layers=2, head_dim=100, hidden_size=400,
                                  intermediate_size=512, num_heads=4, num_kv_heads=4))
    path = tmp_path_factory.mktemp("llama_hd100")
    write_merged_checkpoint(path, cfg, seed=41, shards=2)
    hf = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({**hf, "model_type": "llama"}))
    write_hf_tokenizer(path, cfg.decoder.vocab_size)
    rng = np.random.default_rng(42)
    np.save(path / "video.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))
    return path


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_hd100_model_init_matches_jax(hd100_ckpt, tiny_vision, jax_serving_kernels_interpreted,
                                      quant):
    """The same converted tree and config at hd 100, and the same greedy
    events and tokens from ``infer_events``."""
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    jpipe = jax_model_init(str(hd100_ckpt), dtype=jnp.float32, quant=quant)
    tpipe = model_init(str(hd100_ckpt), dtype=torch.float32, quant=quant, device="cpu")
    jpipe._prepare_memory_layout()
    assert_trees_equal(tpipe.params, jpipe.params)
    dec = tpipe.config.decoder
    assert dec.head_dim == 100 and dec.num_heads == dec.num_kv_heads == 4
    for f in dataclasses.fields(dec):
        if hasattr(jpipe.config.decoder, f.name):
            assert getattr(dec, f.name) == getattr(jpipe.config.decoder, f.name), f.name

    video = str(hd100_ckpt / "video.npy")
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
