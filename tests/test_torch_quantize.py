"""The port's int8 quantization and serving layout against the JAX package's
on the same fp32 weights.

Tolerance: none. Quantization is elementwise IEEE arithmetic and a max, so
``q`` is compared exactly and ``s`` bit for bit (as the int16 view of bf16).
"""

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


def test_int4_and_packed_leaves_wait_for_their_slice(decoder):
    _, tp = decoder
    with pytest.raises(NotImplementedError, match="int4p"):
        tq.quantize_decoder_params(tp, bits=4)
    with pytest.raises(NotImplementedError, match="int4p"):
        tq.quantize_decoder_params(tp, bits=4, pack=True)
    with pytest.raises(NotImplementedError, match="int4p"):
        tq.dequantize({"qp": torch.zeros((2, 4), dtype=torch.int8),
                       "s": torch.ones((1, 4))})


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
