"""The port's int8 and nibble-packed int4 quantization and serving layouts
against the JAX package's on the same fp32 weights.

Tolerance: none. Quantization is elementwise IEEE arithmetic, a max and
integer bit arithmetic, so ``q`` / ``qp`` are compared exactly and ``s`` bit
for bit (as the int16 view of bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model import quantize as jq
from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu.model.config import VisionConfig as JVisionConfig
from trace_tpu.model.mistral import init_decoder_params
from trace_tpu.model.vit import init_vit_params
from trace_tpu_torch.model import quantize as tq
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.params import from_jax_params, init_trace_params

JCFG = JDecoderConfig.tiny()


def _bits(x):
    """A torch or JAX/numpy array as integers: bf16 through its int16 view."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return np.asarray(x).dtype.name


def _assert_same_tree(got, want, path=""):
    assert type(got) is type(want) or not isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), (path, got.shape, want.shape)
    assert _dtype_name(got) == _dtype_name(want), path
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=path)


@pytest.fixture(scope="module")
def decoder():
    jp = init_decoder_params(JCFG, jax.random.PRNGKey(0))
    # an all-zero output channel exercises the 1e-8 floor of the scale
    layers = dict(jp["layers"])
    layers["w_up"] = layers["w_up"].at[:, :, 3].set(0.0)
    jp = {**jp, "layers": layers}
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def test_quantize_decoder_params_is_bit_identical(decoder):
    jp, tp = decoder
    want = jq.quantize_decoder_params(jp)
    got = tq.quantize_decoder_params(tp)
    _assert_same_tree(got, want)
    assert got["layers"]["wq"]["q"].dtype == torch.int8
    assert got["layers"]["wo"]["s"].shape == (JCFG.num_layers, 1, 1, JCFG.hidden_size)
    assert tq.is_quantized(got["lm_head"]) and not tq.is_quantized(got["final_norm"])
    # the host (numpy) variant of the JAX package gives the same tree
    host = jq.quantize_decoder_params_host(jax.tree.map(np.asarray, jp))
    _assert_same_tree(got, host)


def test_fuse_and_unfuse_match_jax(decoder):
    jp, tp = decoder
    jqp, tqp = jq.quantize_decoder_params(jp), tq.quantize_decoder_params(tp)
    jf, tf = jq.fuse_decoder_serving(jqp), tq.fuse_decoder_serving(tqp)
    _assert_same_tree(tf, jf)
    assert "wqkv" in tf["layers"] and "wq" not in tf["layers"]
    nq, nkv = JCFG.num_heads * JCFG.head_dim, JCFG.num_kv_heads * JCFG.head_dim
    assert tf["layers"]["wqkv"]["q"].shape == (JCFG.num_layers, JCFG.hidden_size, nq + 2 * nkv)
    assert tf["layers"]["w_gateup"]["s"].shape == (JCFG.num_layers, 1, 2 * JCFG.intermediate_size)
    _assert_same_tree(tq.unfuse_decoder_serving(tf), jq.unfuse_decoder_serving(jf))
    assert tq.fuse_decoder_serving(tf) is tf
    assert tq.unfuse_decoder_serving(tqp) is tqp


def test_fusion_leaves_ineligible_trees_unchanged(decoder):
    _, tp = decoder
    assert tq.fuse_decoder_serving(tp) is tp  # unquantized
    qp = tq.quantize_decoder_params(tp)
    lora = {**qp, "layers": {**qp["layers"], "wq_lora_a": torch.zeros((2, 4, 4))}}
    assert tq.fuse_decoder_serving(lora) is lora
    biased = {**qp, "layers": {**qp["layers"], "bq": torch.zeros((2, 4))}}
    assert tq.fuse_decoder_serving(biased) is biased
    packed = {**qp, "layers": {**qp["layers"], "wq": {"qp": qp["layers"]["wq"]["q"],
                                                    "s": qp["layers"]["wq"]["s"]}}}
    assert tq.fuse_decoder_serving(packed) is packed


def test_quantize_vision_and_trace_params_match_jax():
    jv = init_vit_params(JVisionConfig.tiny(), jax.random.PRNGKey(1))
    tv = from_jax_params(jax.tree.map(np.asarray, jv))
    _assert_same_tree(tq.quantize_vision_params(tv), jq.quantize_vision_params(jv))
    jd = init_decoder_params(JCFG, jax.random.PRNGKey(2))
    jt = {"decoder": jd, "vision": jv}
    tt = from_jax_params(jax.tree.map(np.asarray, jt))
    _assert_same_tree(tq.quantize_trace_params(tt), jq.quantize_trace_params(jt))
    only_dec = tq.quantize_trace_params(tt, vision=False)
    assert only_dec["vision"] is tt["vision"]


def test_dequantize_matches_jax(decoder):
    jp, tp = decoder
    jleaf = jq.quantize_decoder_params(jp)["layers"]["w_down"]
    tleaf = tq.quantize_decoder_params(tp)["layers"]["w_down"]
    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            _bits(tq.dequantize(tleaf, td)), _bits(jq.dequantize(jleaf, jd)))
    dense = tp["layers"]["w_down"]
    assert tq.dequantize(dense) is dense


def test_native_int4_storage_is_refused(decoder):
    """``bits=4, pack=False`` is ``jnp.int4`` storage in the JAX package; torch
    has no such dtype."""
    _, tp = decoder
    with pytest.raises(NotImplementedError, match="jnp.int4"):
        tq.quantize_decoder_params(tp, bits=4)
    with pytest.raises(ValueError):
        tq.quantize_decoder_params(tp, bits=2, pack=True)


# G = 1 on the tiny config (64 and 128 are no even number of groups of 128);
# G = 2 on the hidden-256 config of the JAX package's grouped tests
WIDE = dataclasses.replace(JCFG, hidden_size=256, intermediate_size=256, num_heads=4,
                           num_kv_heads=2, head_dim=64)


@pytest.fixture(scope="module", params=["tiny", "wide"])
def packed_case(request, decoder):
    if request.param == "tiny":
        jp, tp = decoder
        return JCFG, jp, tp
    jp = init_decoder_params(WIDE, jax.random.PRNGKey(3))
    layers = dict(jp["layers"])
    layers["w_up"] = layers["w_up"].at[:, :128, 3].set(0.0)  # one all-zero group
    jp = {**jp, "layers": layers}
    return WIDE, jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("group", [128, 0])
def test_int4p_quantization_is_bit_identical(packed_case, group):
    cfg, jp, tp = packed_case
    want = jq.quantize_decoder_params(jp, bits=4, pack=True, group=group)
    got = tq.quantize_decoder_params(tp, bits=4, pack=True, group=group)
    _assert_same_tree(got, want)
    G = 2 if (cfg is WIDE and group) else 1
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    nq = cfg.num_heads * cfg.head_dim
    assert got["layers"]["wq"]["qp"].shape == (L, D // 2, nq)
    assert got["layers"]["wq"]["qp"].dtype == torch.int8
    assert got["layers"]["wo"]["s"].shape == (L, G, D)
    assert got["layers"]["w_down"]["qp"].shape == (L, I // 2, D)
    assert tq.is_packed4(got["layers"]["wq"]) and tq.packed4_groups(got["layers"]["wq"]) == G
    # lm_head stays int8 in 4-bit mode
    assert set(got["lm_head"]) == {"q", "s"} and not tq.is_packed4(got["lm_head"])
    # the host (numpy) variant of the JAX package gives the same tree
    host = jq.quantize_decoder_params_host(jax.tree.map(np.asarray, jp), bits=4, pack=True,
                                           group=group)
    _assert_same_tree(got, host)


@pytest.mark.parametrize("group", [128, 0])
def test_int4p_fuse_and_unfuse_match_jax(packed_case, group):
    cfg, jp, tp = packed_case
    jqp = jq.quantize_decoder_params(jp, bits=4, pack=True, group=group)
    tqp = tq.quantize_decoder_params(tp, bits=4, pack=True, group=group)
    jf, tf = jq.fuse_decoder_serving(jqp), tq.fuse_decoder_serving(tqp)
    _assert_same_tree(tf, jf)
    assert "wqkv" in tf["layers"] and "wq" not in tf["layers"]
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    G = tqp["layers"]["wq"]["s"].shape[1]
    assert tf["layers"]["wqkv"]["qp"].shape == (cfg.num_layers, cfg.hidden_size // 2,
                                                nq + 2 * nkv)
    assert tf["layers"]["w_gateup"]["s"].shape == (cfg.num_layers, G, 2 * cfg.intermediate_size)
    back = tq.unfuse_decoder_serving(tf)
    _assert_same_tree(back, jq.unfuse_decoder_serving(jf))
    for name in ("wq", "wk", "wv", "w_gate", "w_up"):
        _assert_same_tree(back["layers"][name], tqp["layers"][name])
    assert tq.fuse_decoder_serving(tf) is tf


@pytest.mark.parametrize("group", [128, 0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int4p_dequantize_matches_jax(packed_case, group, dtype):
    _, jp, tp = packed_case
    jqp = jq.quantize_decoder_params(jp, bits=4, pack=True, group=group)["layers"]
    tqp = tq.quantize_decoder_params(tp, bits=4, pack=True, group=group)["layers"]
    for name in ("wo", "w_up"):
        got = tq.dequantize(tqp[name], getattr(torch, dtype))
        want = jq.dequantize(jqp[name], getattr(jnp, dtype))
        assert tuple(got.shape) == want.shape  # the flattened [L, K, N] view
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pack4_and_unpack4_match_jax():
    rng = np.random.default_rng(4)
    q = rng.integers(-8, 8, (2, 16, 6), dtype=np.int8)
    packed = tq.pack4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (2, 8, 6)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack4(jnp.asarray(q))))
    assert torch.equal(tq.unpack4(packed), torch.from_numpy(q))
    # every byte value: low nibble sign-extended, high nibble by arithmetic shift
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    got = tq.unpack4(torch.from_numpy(every))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.unpack4(jnp.asarray(every))))
    assert got.dtype == torch.int8 and got.min() == -8 and got.max() == 7
    with pytest.raises(ValueError):
        tq.pack4(torch.zeros((3, 4), dtype=torch.int8))


def test_converted_quantized_trees_arrive_bit_for_bit(decoder):
    """``from_jax_params`` on a quantized and fused JAX tree: int8 ``q`` and
    bf16 ``s`` keep their bits and dtypes."""
    jp, tp = decoder
    jf = jq.fuse_decoder_serving(jq.quantize_decoder_params(jp))
    conv = from_jax_params(jax.tree.map(np.asarray, jf))
    _assert_same_tree(conv, jf)
    assert conv["layers"]["wqkv"]["q"].dtype == torch.int8
    assert conv["lm_head"]["s"].dtype == torch.bfloat16
    _assert_same_tree(conv, tq.fuse_decoder_serving(tq.quantize_decoder_params(tp)))


@pytest.mark.parametrize("fused", [True, False])
def test_converted_packed_trees_arrive_bit_for_bit(packed_case, fused):
    """``from_jax_params`` on a packed tree from the JAX package's host
    quantizer (numpy int8 bytes, ``ml_dtypes.bfloat16`` scales), fused or not."""
    _, jp, tp = packed_case
    host = jq.quantize_decoder_params_host(jax.tree.map(np.asarray, jp), bits=4, pack=True)
    want = tq.quantize_decoder_params(tp, bits=4, pack=True)
    if fused:
        host, want = jq.fuse_decoder_serving(host), tq.fuse_decoder_serving(want)
    assert isinstance(host["layers"]["wo"]["qp"], np.ndarray)
    conv = from_jax_params(host)
    _assert_same_tree(conv, want)
    assert conv["layers"]["wo"]["qp"].dtype == torch.int8
    assert conv["layers"]["wo"]["s"].dtype == torch.bfloat16


def test_int8_serving_gives_the_serving_pair():
    cfg = TraceConfig.tiny()
    params = init_trace_params(cfg, torch.Generator().manual_seed(0))
    qparams, qcfg = tq.int8_serving(params, cfg)
    assert qcfg.decoder.kv_cache_dtype == "int8" and qcfg.decoder.act_quant
    assert qcfg.vision.act_quant
    layers = qparams["decoder"]["layers"]
    assert sorted(layers) == ["attn_norm", "mlp_norm", "w_down", "w_gateup", "wo", "wqkv"]
    assert tq.is_quantized(qparams["decoder"]["lm_head"])
    assert tq.is_quantized(qparams["vision"]["layers"]["fc1"])
    assert tq.is_quantized(qparams["vision"]["patch_embed"])
    assert qparams["connector"] is params["connector"]
    assert torch.is_tensor(params["decoder"]["layers"]["wq"])  # the input tree is kept
    dparams, dcfg = tq.int8_serving(params, cfg, vision=False)
    assert dparams["vision"] is params["vision"] and not dcfg.vision.act_quant


@pytest.mark.parametrize("group", [128, 0])
def test_int4p_serving_gives_the_serving_pair(group):
    cfg = TraceConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_size=256, intermediate_size=256, head_dim=64))
    params = init_trace_params(cfg, torch.Generator().manual_seed(0))
    qparams, qcfg = tq.int4p_serving(params, cfg, group=group)
    assert qcfg.decoder.kv_cache_dtype == "int8" and qcfg.decoder.act_quant
    assert qcfg.vision.act_quant
    layers = qparams["decoder"]["layers"]
    assert sorted(layers) == ["attn_norm", "mlp_norm", "w_down", "w_gateup", "wo", "wqkv"]
    for name in ("w_down", "w_gateup", "wo", "wqkv"):
        assert tq.is_packed4(layers[name])
        assert tq.packed4_groups(layers[name]) == (2 if group else 1)
    assert set(qparams["decoder"]["lm_head"]) == {"q", "s"}
    assert tq.is_quantized(qparams["vision"]["layers"]["fc1"])  # the int8 W8A8 ViT
    assert torch.is_tensor(params["decoder"]["layers"]["wq"])  # the input tree is kept
    dparams, dcfg = tq.int4p_serving(params, cfg, vision=False, group=group)
    assert dparams["vision"] is params["vision"] and not dcfg.vision.act_quant
