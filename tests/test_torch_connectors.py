"""The port's connectors (trace_tpu_torch/model/connector.py and
stc_connector.py) against the JAX package's: every type of
``build_connector``, the STC family included.

Forwards run on the same weights (made by JAX, bridged by
``from_jax_params``) in fp32: the same arithmetic, summed in other orders
and, for the STC family, convolved by another library, so within 2e-4
relative and 2e-5 absolute (the limits of tests/test_stc_parity.py). Init
layouts (paths, shapes, dtypes) and converted leaves (bit for bit: values
are only moved and cast) are compared exactly. Last, ``model_init`` on a
merged checkpoint with an STC and an ``mlp2x_gelu`` connector, whose
features take the global-pooling layout (no time tokens between frames),
against the JAX package's: the same tree, events and greedy tokens.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file as save_torch

from test_stc_parity import TorchSTC
from test_torch_checkpoint import (
    assert_trees_equal,
    jax_config,
    tiny_vision,  # noqa: F401  (a fixture)
    write_hf_tokenizer,
    write_merged_checkpoint,
)
from trace_tpu.checkpoint import convert as jconvert
from trace_tpu.model import connector as jconnector
from trace_tpu.model import trace_model as jtm
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.runtime import generate as jgen
from trace_tpu.video.io import load_video_frames as jax_load_video
from trace_tpu_torch.checkpoint import convert as tconvert
from trace_tpu_torch.model import connector as tconnector
from trace_tpu_torch.model import trace_model as ttm
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.params import _connector, _Init, from_jax_params, init_trace_params
from trace_tpu_torch.train.train import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MM, LM = 32, 48
STC = ["stc_connector", "stp_connector", "stc_connector_v35", "spatial_conv", "spatial_pool"]
TYPES = ["spatial_slot", "slot", "linear", "mlp2x_gelu", "mlp3x_gelu", "identity",
         "spatial_time_slot"] + STC
GLOBAL = {"slot", "linear", "mlp2x_gelu", "mlp3x_gelu"} | set(STC)
RTOL, ATOL = 2e-4, 2e-5


def _jax_init(ptype, key=0):
    init, _ = jconnector.build_connector(ptype)
    kw = {"num_slots": 4} if ptype in ("spatial_slot", "slot") else {}
    return init(jax.random.PRNGKey(key), MM, LM, **kw)


def _features(ptype, seed=0):
    """[B, T, N, D_mm]: a 4 x 4 patch grid; spatial_time_slot splits a
    frame's tokens at 576, so 576 image tokens and 4 time tokens there."""
    rng = np.random.default_rng(seed)
    shape = (1, 2, 580, MM) if ptype == "spatial_time_slot" else (2, 4, 16, MM)
    return rng.standard_normal(shape).astype(np.float32)


def _jax_paths(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("ptype", TYPES)
def test_connector_forward_matches_jax(ptype):
    jp = _jax_init(ptype)
    x = _features(ptype)
    _, jfwd = jconnector.build_connector(ptype)
    _, tfwd = tconnector.build_connector(ptype)
    want = np.asarray(jfwd(jp, jnp.asarray(x)))
    got = tfwd(from_jax_params(jax.tree.map(np.asarray, jp)), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.ndim == (3 if ptype in GLOBAL else 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ptype", TYPES)
def test_connector_init_layout_matches_jax(ptype):
    """The port's init of a TRACE config's connector: JAX's leaf paths,
    shapes and dtypes (the values come from another generator); bf16 as
    the serving dtype."""
    jcfg = dataclasses.replace(JTraceConfig.tiny(), mm_projector_type=ptype)
    cfg = dataclasses.replace(TraceConfig.tiny(), mm_projector_type=ptype,
                              dtype=torch.bfloat16)
    want = _jax_paths(jtm.init_trace_params(jcfg, jax.random.PRNGKey(0),
                                            dtype=jnp.bfloat16)["connector"])
    got = dict(tree_paths(_connector(cfg, _Init(torch.Generator().manual_seed(0), "cpu",
                                                 torch.bfloat16))))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert leaf.dtype == torch.bfloat16 and want[path].dtype == jnp.bfloat16, path


def test_init_trace_params_takes_every_connector():
    for ptype in TYPES:
        cfg = dataclasses.replace(TraceConfig.tiny(), mm_projector_type=ptype)
        params = init_trace_params(cfg, torch.Generator().manual_seed(0))
        _, fwd = tconnector.build_connector(ptype)
        x = torch.from_numpy(_features(ptype))[..., :cfg.vision.hidden_size]
        assert torch.isfinite(fwd(params["connector"], x)).all(), ptype


def _state_dict(ptype, seed=0) -> dict:
    """An mm_projector state dict of ``ptype`` (``model.mm_projector.``
    keys, HF layouts): the STC family from the torch replica of the
    reference's module tree, the others by hand."""
    torch.manual_seed(seed)
    if ptype in STC:
        from trace_tpu.model.stc_connector import SPECS

        sd = TorchSTC(MM, LM, SPECS[ptype]).state_dict()
    elif ptype == "linear":
        sd = {"weight": torch.randn(LM, MM), "bias": torch.randn(LM)}
    elif ptype.startswith("mlp"):
        depth = int(ptype[3])
        sd = {}
        for i in range(depth):
            sd[f"{2 * i}.weight"] = torch.randn(LM, MM if i == 0 else LM) * 0.1
            sd[f"{2 * i}.bias"] = torch.randn(LM) * 0.1
    elif ptype == "spatial_time_slot":
        sd = {"spatial_slots": torch.randn(MM, 8), "time_slots": torch.randn(MM, 1),
              "ln_vision.weight": 1 + 0.1 * torch.randn(MM),
              "ln_vision.bias": 0.1 * torch.randn(MM), "readout.weight": torch.randn(LM, MM)}
    elif ptype in ("spatial_slot", "slot"):
        sd = {"slots": torch.randn(MM, 4), "ln_vision.weight": 1 + 0.1 * torch.randn(MM),
              "ln_vision.bias": 0.1 * torch.randn(MM), "readout.weight": torch.randn(LM, MM)}
    else:
        sd = {}
    return {f"model.mm_projector.{k}": v.detach().clone() for k, v in sd.items()}


def _configs(ptype, **kw):
    return (dataclasses.replace(JTraceConfig.tiny(), mm_projector_type=ptype, **kw),
            dataclasses.replace(TraceConfig.tiny(), mm_projector_type=ptype, **kw))


@pytest.mark.parametrize("ptype", TYPES)
def test_converter_matches_jax(ptype):
    """The port's converter and the JAX package's on one state dict: the
    same leaves bit for bit, fp32 and bf16."""
    sd = _state_dict(ptype)
    jcfg, cfg = _configs(ptype)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    for jdtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        if ptype == "spatial_slot":
            want = jconvert.convert_spatial_slot(sd_np, dtype=jdtype)
        else:
            want = jconvert._convert_generic_projector(sd_np, jcfg, dtype=jdtype)
        got = tconvert.convert_connector(sd, cfg, dtype=tdtype)
        assert_trees_equal(_as_dicts(got), _as_dicts(want))


def _as_dicts(tree):
    """Lists as dicts of their indices, for ``assert_trees_equal``."""
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_dicts(v) for i, v in enumerate(tree)}
    return tree


@pytest.mark.parametrize("ptype,prefixed", [("stc_connector", False),
                                            ("mlp2x_gelu", True)])
def test_load_mm_projector_matches_jax(tmp_path, ptype, prefixed):
    """A stage-1 ``mm_projector.bin``, its keys with or without the
    ``model.mm_projector.`` prefix."""
    sd = _state_dict(ptype, seed=3)
    if not prefixed:
        sd = {k[len("model.mm_projector."):]: v for k, v in sd.items()}
    torch.save(sd, tmp_path / "mm_projector.bin")
    jcfg, cfg = _configs(ptype)
    want = jconvert.load_mm_projector(str(tmp_path / "mm_projector.bin"), jcfg)
    got = tconvert.load_mm_projector(str(tmp_path / "mm_projector.bin"), cfg)
    assert_trees_equal(_as_dicts(got), _as_dicts(want))


@pytest.mark.parametrize("ptype", ["mlp2x_gelu", "stc_connector_v35"])
def test_global_pooling_encode_matches_jax(ptype):
    """``encode_video`` of a global-pooling connector: [B, S, D_lm], no time
    tokens, the JAX package's values; and its training forward's loss."""
    jcfg, cfg = _configs(ptype)
    jp = jtm.init_trace_params(jcfg, jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, jcfg.num_frames, 56, 56, 3)).astype(np.float32)
    ids = rng.integers(2, 12, (2, jcfg.num_frames, 6)).astype(np.int32)
    want = np.asarray(jtm.encode_video(jp, jcfg, jnp.asarray(frames), jnp.asarray(ids)))
    got = ttm.encode_video(tp, cfg, torch.from_numpy(frames), torch.from_numpy(ids),
                           remat_connector=True)
    assert got.ndim == 3 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# model_init on a merged checkpoint with another connector: the manifest's
# keys for a spatial_slot model, the connector's own keys in a fourth shard,
# config.json naming the connector. Both packages convert (fp32) and serve
# the same ``.npy`` video; the JAX side runs its kernels interpreted.
# ---------------------------------------------------------------------------

ASK = "Localize a series of activity events in the video ."


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    from trace_tpu.kernels import flash_attention as jfa

    monkeypatch.setenv("TRACE_TPU_DECODE_ATTN", "force")
    monkeypatch.setattr(jgen, "default_use_flash", lambda: True)
    monkeypatch.setattr(
        jfa, "flash_attention_trainable",
        lambda q, k, v, bias, causal=False: jfa.flash_attention(
            q, k, v, bias, causal=causal, interpret=True))


def _connector_checkpoint(path, ptype):
    cfg = jax_config(decoder=dict(num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                                  hidden_size=256, intermediate_size=256))
    write_merged_checkpoint(path, cfg, seed=21, shards=3)
    mm, lm = cfg.vision.hidden_size, cfg.decoder.hidden_size
    torch.manual_seed(22)
    if ptype in STC:
        from trace_tpu.model.stc_connector import SPECS

        sd = TorchSTC(mm, lm, SPECS[ptype]).state_dict()
    else:
        sd = {"0.weight": torch.randn(lm, mm) * 0.2, "0.bias": torch.randn(lm) * 0.1,
              "2.weight": torch.randn(lm, lm) * 0.2, "2.bias": torch.randn(lm) * 0.1}
    save_torch({f"model.mm_projector.{k}": v.detach().to(torch.bfloat16).contiguous()
                for k, v in sd.items()}, str(path / "model-extra.safetensors"))
    hf = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({**hf, "mm_projector_type": ptype}))
    write_hf_tokenizer(path, cfg.decoder.vocab_size)
    rng = np.random.default_rng(23)
    np.save(path / "video.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))


@pytest.mark.parametrize("ptype", ["stc_connector", "mlp2x_gelu"])
def test_model_init_with_a_global_connector_matches_jax(tmp_path, tiny_vision,
                                                        jax_kernels_interpreted, ptype):
    from trace_tpu.runtime.pipeline import model_init as jax_model_init
    from trace_tpu_torch.runtime.pipeline import model_init

    _connector_checkpoint(tmp_path, ptype)
    jpipe = jax_model_init(str(tmp_path), dtype=jnp.float32, quant="bf16")
    tpipe = model_init(str(tmp_path), dtype=torch.float32, quant="bf16", device="cpu")
    jpipe._prepare_memory_layout()
    assert tpipe.config.mm_projector_type == ptype
    assert_trees_equal(_as_dicts(tpipe.params), _as_dicts(jpipe.params))

    video = str(tmp_path / "video.npy")
    want = jpipe.infer_events(video, ASK, max_new_tokens=24)
    got = tpipe.infer_events(video, ASK, max_new_tokens=24)
    assert got.to_dict() == want.to_dict()
    frames, ts = jax_load_video(video, jpipe.config.num_frames)
    jprefix, jmask = jpipe._prepare_prefix_batch([frames], [ts], [ASK])
    tprefix, _ = tpipe.encode_prefix([frames], [ts], [ASK])
    np.testing.assert_allclose(tprefix.numpy(), np.asarray(jprefix), rtol=RTOL, atol=ATOL)
    jtok = jgen.generate(jpipe._decoder_params, jpipe.config.decoder, jprefix, jmask,
                         jpipe._combined, max_new_tokens=24, initial_head=1,
                         eos_id=jpipe.tokenizer.eos_token_id, use_flash=True)
    np.testing.assert_array_equal(tpipe.last_stats["tokens"], jtok.tokens)
    assert tpipe.last_stats["decode_steps"] > 0
