"""The port's vision prefix (preprocess, ViT, spatial_slot connector, splice)
against the JAX package's on the tiny config, fp32, same weights and inputs.

Tolerance: 1e-5 on fp32 values unless a test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model import connector as jconn
from trace_tpu.model import trace_model as jtm
from trace_tpu.model import vit as jvit
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.video.preprocess import preprocess_frames as jax_preprocess
from trace_tpu_torch.model import connector as tconn
from trace_tpu_torch.model import trace_model as ttm
from trace_tpu_torch.model import vit as tvit
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.params import from_jax_params, init_trace_params
from trace_tpu_torch.video.preprocess import preprocess_frames, resize_weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
JCFG = JTraceConfig.tiny()
CFG = TraceConfig.tiny()


@pytest.fixture(scope="module")
def params():
    jp = jtm.init_trace_params(JCFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _images(n, seed=0):
    S = CFG.vision.image_size
    return np.random.default_rng(seed).standard_normal((n, S, S, 3)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
def test_vit_forward_matches(params, use_flash):
    """The port's one path (tokens padded to a multiple of 16, attention
    through vit_attention_btd, its plain version on the CPU) against both
    of the JAX package's branches: unpadded einsum attention, and the padded
    path through its reference."""
    jp, tp = params
    x = _images(3)
    want = jvit.vit_forward(jp["vision"], JCFG.vision, jnp.asarray(x), use_flash=use_flash)
    got = tvit.vit_forward(tp["vision"], CFG.vision, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_fused_qkv_vit_matches_unfused(params):
    _, tp = params
    x = torch.from_numpy(_images(2, seed=1))
    fused = tvit.fuse_vision_qkv(tp["vision"])
    assert "wqkv" in fused["layers"] and "wq" not in fused["layers"]
    _close(tvit.vit_forward(fused, CFG.vision, x),
           tvit.vit_forward(tp["vision"], CFG.vision, x).numpy())


def test_extract_patches_and_layer_norm_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 28, 42, 3)).astype(np.float32)
    _close(tvit.extract_patches(torch.from_numpy(x), 14),
           jvit.extract_patches(jnp.asarray(x), 14))
    h = rng.standard_normal((4, 32)).astype(np.float32) * 3 + 1
    s, b = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    _close(tvit.layer_norm(*map(torch.from_numpy, (h, s, b)), 1e-5),
           jvit.layer_norm(*map(jnp.asarray, (h, s, b)), 1e-5))


def test_spatial_slot_forward_matches(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16, CFG.vision.hidden_size)).astype(np.float32)
    want = jconn.spatial_slot_forward(jp["connector"], jnp.asarray(x))
    got = tconn.spatial_slot_forward(tp["connector"], torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, CFG.num_slots, CFG.decoder.hidden_size)
    _close(got, want)


def test_encode_prefix_for_generation_matches(params):
    jp, tp = params
    B, T = 2, CFG.num_frames
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((B, T) + (CFG.vision.image_size,) * 2 + (3,)).astype(np.float32)
    time_ids = rng.integers(0, 13, (B, T, 6)).astype(np.int32)
    L = 10 + T * ttm.tokens_per_frame(CFG)
    ids = rng.integers(0, CFG.decoder.combined_vocab_size, (B, L)).astype(np.int32)
    pos = np.array([3, 7], np.int32)
    want = jtm.encode_prefix_for_generation(
        jp, JCFG, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(frames),
        jnp.asarray(time_ids))
    got = ttm.encode_prefix_for_generation(
        tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(pos),
        torch.from_numpy(frames), torch.from_numpy(time_ids).long())
    _close(got, want)


def test_vit_chunking_matches_one_batch(params):
    import dataclasses

    _, tp = params
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.standard_normal(
        (1, 8) + (CFG.vision.image_size,) * 2 + (3,)).astype(np.float32))
    ids = torch.zeros((1, 8, 6), dtype=torch.long)
    one = ttm.encode_video(tp, dataclasses.replace(CFG, vit_chunk_size=0), frames, ids)
    chunked = ttm.encode_video(tp, dataclasses.replace(CFG, vit_chunk_size=2), frames, ids)
    _close(chunked, one.numpy())


@pytest.mark.parametrize(
    "shape,aspect",
    [
        ((3, 56, 56, 3), "pad"),    # already square at the ViT size: no resize
        ((3, 64, 48, 3), "pad"),    # pad to 64x64, downscale to 56
        ((2, 30, 40, 3), "pad"),    # pad to 40x40, upscale to 56
        ((2, 70, 50, 3), "resize"),  # direct resize, each axis its own scale
    ],
)
def test_preprocess_frames_matches(shape, aspect):
    frames = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    S = CFG.vision.image_size
    want = jax_preprocess(jnp.asarray(frames), S, aspect_ratio=aspect)
    got = preprocess_frames(torch.from_numpy(frames), S, aspect_ratio=aspect)
    # normalized values span ~[-1.8, 2.1]; fp32 products in another order
    _close(got, want, 2e-5)


@pytest.mark.parametrize("n_in,n_out", [(64, 56), (40, 56), (336, 224), (17, 5)])
def test_resize_weights_match_jax(n_in, n_out):
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    want = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                              _fill_keys_cubic_kernel, True)
    _close(resize_weights(n_in, n_out), want, 1e-6)


def test_init_trace_params_layout_matches_jax():
    """The port's random init has the JAX tree's structure, shapes and
    dtypes, and its init scales."""
    want = jax.eval_shape(lambda: jtm.init_trace_params(JCFG, jax.random.PRNGKey(0)))
    got = init_trace_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert abs(float(got["decoder"]["layers"]["w_up"].std()) - 0.02) < 2e-3
    assert abs(float(got["connector"]["slots"].std()) - 1.0) < 0.3
    assert bool((got["vision"]["layers"]["ln1_scale"] == 1).all())


# int8 ViT. W8A8 (``act_quant``): both sides compute the same function in
# fp32 activations; fp32 summation order differs (~1e-6), and where that
# falls on a rounding boundary one int8 activation flips by a step, which
# moves that token's output by ~1/127 of one of K = 32..64 terms. Limit: 2e-3
# of the largest feature (measured on these seeds: under 1e-5, no flip).
# Weight-only (``act_quant`` off): dense products on the dequantized
# weights. The port rounds ``q * s`` to bf16 as the JAX source writes it; XLA
# on the CPU keeps the product in fp32 inside the layer scan (it is allowed
# excess precision and drops the f32 -> bf16 -> f32 pair), so each weight
# differs by up to 2^-9 of itself and the features by ~1e-4 (measured
# 1.05e-4 on values up to ~2): limit 5e-4. On the dequantized dense tree
# the two agree to 3e-6.
W8A8_TOL = 2e-3
WEIGHT_ONLY_TOL = 5e-4


@pytest.fixture(scope="module")
def int8_vision(params):
    from trace_tpu.model import quantize as jq

    jv = jq.quantize_vision_params(params[0]["vision"])
    return jv, from_jax_params(jax.tree.map(np.asarray, jv))


@pytest.mark.parametrize("use_flash", [False, True])
def test_w8a8_vit_forward_matches(int8_vision, use_flash):
    import dataclasses

    jv, tv = int8_vision
    x = _images(3, seed=7)
    jcfg = dataclasses.replace(JCFG.vision, act_quant=True)
    tcfg = dataclasses.replace(CFG.vision, act_quant=True)
    want = np.asarray(jvit.vit_forward(jv, jcfg, jnp.asarray(x), use_flash=use_flash))
    got = tvit.vit_forward(tv, tcfg, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    unit = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / unit, want / unit, rtol=W8A8_TOL, atol=W8A8_TOL)
    # and it is the int8 function, not the dense one
    dense = tvit.vit_forward(tv, CFG.vision, torch.from_numpy(x))
    assert (got - dense).abs().max() > 1e-4 * unit


def test_weight_only_int8_vit_matches(int8_vision):
    jv, tv = int8_vision
    x = _images(2, seed=8)
    want = jvit.vit_forward(jv, JCFG.vision, jnp.asarray(x))
    _close(tvit.vit_forward(tv, CFG.vision, torch.from_numpy(x)), want, WEIGHT_ONLY_TOL)


def test_fuse_vision_qkv_leaves_an_int8_tree_as_it_is(int8_vision):
    jv, tv = int8_vision
    assert tvit.fuse_vision_qkv(tv) is tv
    assert jvit.fuse_vision_qkv(jv) is jv
