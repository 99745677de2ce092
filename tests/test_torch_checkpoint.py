"""The port's checkpoint readers and converters (trace_tpu_torch/checkpoint)
against the JAX package's on the same files: tensors and converted leaves
bit for bit where values are only moved and cast, the LoRA merge (an fp32
sum) within 1e-6 of the largest value. Checkpoints are written in the test:
tiny HF models through ``transformers`` (as tests/test_base_model_init.py
and tests/test_checkpoint_parity.py build them) and merged TRACE dirs with
the keys and shapes of ``scripts/parity/manifest.py full_manifest``.

The JAX package converts with the default CLIP ViT-L/14-336 geometry (its
``trace_config_from_hf`` reads no vision fields); the tests that convert a
whole dir give both packages the tiny vision config through a wrapper of
``trace_config_from_hf`` (fixture ``tiny_vision``)."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from trace_tpu.checkpoint import convert as jconvert
from trace_tpu.checkpoint import loader as jloader
from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.config import VisionConfig as JVisionConfig
from trace_tpu_torch.checkpoint import convert as tconvert
from trace_tpu_torch.checkpoint import loader as tloader
from trace_tpu_torch.model.config import DecoderConfig, TraceConfig, VisionConfig

ROOT = Path(__file__).resolve().parents[1]
LORA_TOL = 1e-6  # of the largest |value| of a merged weight: fp32 sums in another order


def _manifest_module():
    spec = importlib.util.spec_from_file_location(
        "parity_manifest", ROOT / "scripts" / "parity" / "manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MANIFEST = _manifest_module()


def jax_config(decoder=None, **kw) -> JTraceConfig:
    """The tiny TRACE config (12 decoder layers, so that ``layers.10`` and
    ``layers.2`` both exist), widths as given."""
    dec = dataclasses.replace(JDecoderConfig.tiny(), **{"num_layers": 12, **(decoder or {})})
    return dataclasses.replace(JTraceConfig.tiny(), decoder=dec, **kw)


def hf_config_of(cfg: JTraceConfig) -> dict:
    d = cfg.decoder
    return {
        "model_type": "mistral", "vocab_size": d.vocab_size, "hidden_size": d.hidden_size,
        "intermediate_size": d.intermediate_size, "num_hidden_layers": d.num_layers,
        "num_attention_heads": d.num_heads, "num_key_value_heads": d.num_kv_heads,
        "head_dim": d.head_dim, "rope_theta": d.rope_theta, "rms_norm_eps": d.rms_eps,
        "mm_projector_type": cfg.mm_projector_type, "num_slots": cfg.num_slots,
        "num_frames": cfg.num_frames, "image_aspect_ratio": cfg.image_aspect_ratio,
    }


def _value(key: str, shape, rng) -> np.ndarray:
    """Values by role: norms near 1, biases small; output heads, embedding
    and tower tables and connector slots N(0, 1) (a greedy stream then
    crosses the three heads); other weights N(0, 0.02)."""
    if key.endswith(("norm.weight", "layernorm.weight", "layer_norm1.weight",
                     "layer_norm2.weight", "ln_vision.weight", "pre_layrnorm.weight")):
        return 1.0 + 0.05 * rng.standard_normal(shape)
    if key.endswith(".bias"):
        return 0.02 * rng.standard_normal(shape)
    if key.endswith(("head.weight", "embed_tokens.weight", ".slots")):
        return rng.standard_normal(shape)
    return 0.02 * rng.standard_normal(shape)


def write_merged_checkpoint(path: Path, cfg: JTraceConfig, *, seed=0, dtype=torch.bfloat16,
                            shards=3, drop=(), extra_rows=0) -> dict:
    """A merged TRACE checkpoint dir: the manifest's keys and shapes for
    ``cfg`` (vision bundled) in ``shards`` safetensors files of ``dtype``,
    without the keys in ``drop``, with ``extra_rows`` more rows in
    ``embed_tokens`` and ``lm_head`` (the converters keep the first
    ``vocab_size``), and ``config.json``. Returns the state dict written."""
    manifest = MANIFEST.full_manifest(cfg, "merged", bundled_vision=True)
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in manifest.items():
        if key in drop:
            continue
        shape = list(shape)
        if key.endswith("embed_tokens.weight") or key == "lm_head.weight":
            shape[0] += extra_rows
        sd[key] = torch.from_numpy(np.asarray(_value(key, shape, rng), np.float32)).to(dtype)
    path.mkdir(parents=True, exist_ok=True)
    keys = list(sd)
    for s in range(shards):
        part = {k: sd[k].contiguous() for k in keys[s::shards]}
        save_torch(part, str(path / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    (path / "config.json").write_text(json.dumps(hf_config_of(cfg)))
    return sd


def write_hf_tokenizer(path: Path, vocab_size: int) -> None:
    """A word-level ``PreTrainedTokenizerFast`` of ``vocab_size`` ids (<unk>,
    <s>, </s>, prompt words, fillers), saved where ``AutoTokenizer`` finds it,
    with no download."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = list(dict.fromkeys(["<unk>", "<s>", "</s>"] + (
        "Localize a series of activity events in the video , output the start and "
        "end timestamp for each event describe with sentences . What is shown ? "
        "INST SYS [ ] < > / Find".split())))
    words += [f"w{i}" for i in range(vocab_size - len(words))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(path))


def _np(x) -> np.ndarray:
    """A leaf of either package as numpy, bf16 as its raw 16 bits."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def assert_trees_equal(got, want, close=()):
    """Same leaf paths, shapes and dtypes; values bit for bit, except the
    leaves in ``close``: within LORA_TOL of their largest |value|."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for name in g:
        a, b = _np(g[name]), _np(w[name])
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype, b.dtype)
        if name in close:
            a32 = torch.from_numpy(a).view(torch.bfloat16).float() if a.dtype == np.int16 else a
            b32 = torch.from_numpy(b).view(torch.bfloat16).float() if b.dtype == np.int16 else b
            a32, b32 = np.asarray(a32, np.float32), np.asarray(b32, np.float32)
            assert np.abs(a32 - b32).max() <= LORA_TOL * np.abs(b32).max(), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture
def tiny_vision(monkeypatch):
    """Both packages' ``trace_config_from_hf`` with the tiny vision tower."""
    for mod, vision in ((jconvert, JVisionConfig.tiny()), (tconvert, VisionConfig.tiny())):
        orig = mod.trace_config_from_hf
        monkeypatch.setattr(mod, "trace_config_from_hf",
                            lambda hf, _o=orig, _v=vision, **kw: _o(hf, **{"vision": _v, **kw}))


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int8"])
def test_safetensors_dir_reads_the_stored_bits(tmp_path, dtype):
    """Three shards with odd element counts (so tensors start at offsets of
    every alignment), a scalar and an empty tensor: the port's reader gives
    the bytes and shapes ``safetensors`` (through JAX's loader) gives."""
    rng = np.random.default_rng(1)
    tdt = getattr(torch, dtype)
    shapes = {"a.weight": (3, 5), "b": (7,), "c.x": (2, 3, 1), "d": (), "e": (0, 4)}
    for s in range(3):
        part = {}
        for key, shape in shapes.items():
            v = torch.from_numpy(np.asarray(rng.standard_normal(shape) * 50, np.float32))
            part[f"s{s}.{key}"] = v.to(tdt)
        save_torch(part, str(tmp_path / f"m{s}.safetensors"))
    save_torch({"s0.a.weight": torch.ones(3, 5, dtype=tdt)}, str(tmp_path / "z.safetensors"))
    got = tconvert.load_safetensors_dir(str(tmp_path))
    want = jconvert.load_safetensors_dir(str(tmp_path))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == tdt and tuple(got[key].shape) == want[key].shape
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]), err_msg=key)
    assert (got["s0.a.weight"] == 1).all()  # the later shard wins, in sorted order


def test_single_files_and_bins_read_like_jax(tmp_path):
    rng = np.random.default_rng(2)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "q": rng.integers(-128, 128, (5,)).astype(np.int8)}
    save_numpy(arrays, str(tmp_path / "one.safetensors"))
    got = tconvert.load_checkpoint_tensors(str(tmp_path / "one.safetensors"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    state = {"model.mm_projector.slots": torch.randn(4, 3).to(torch.bfloat16),
             "x": torch.arange(6, dtype=torch.int64)}
    torch.save(state, tmp_path / "mm_projector.bin")
    got = tconvert.load_checkpoint_tensors(str(tmp_path / "mm_projector.bin"))
    want = jconvert.load_checkpoint_tensors(str(tmp_path / "mm_projector.bin"))
    assert sorted(got) == sorted(want)
    for k in want:  # the JAX package widens to fp32; the values are the same
        np.testing.assert_array_equal(got[k].float().numpy(), want[k])
    (tmp_path / "bins").mkdir()
    torch.save({"a": torch.ones(2)}, tmp_path / "bins" / "pytorch_model-1.bin")
    torch.save({"b": torch.zeros(3)}, tmp_path / "bins" / "pytorch_model-2.bin")
    assert sorted(tconvert.load_checkpoint_tensors(str(tmp_path / "bins"))) == ["a", "b"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tconvert.load_checkpoint_tensors(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# Converters on HF modules' state dicts
# ---------------------------------------------------------------------------

def _mistral_sd(heads: bool):
    from transformers import MistralConfig, MistralForCausalLM

    hf_cfg = MistralConfig(
        vocab_size=390, hidden_size=64, intermediate_size=128, num_hidden_layers=12,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=512, rms_norm_eps=1e-5, sliding_window=None,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    sd = {k: v.detach() for k, v in MistralForCausalLM(hf_cfg).state_dict().items()}
    if heads:
        for name, width in (("sync_head", 1), ("time_head", 13), ("score_head", 13)):
            sd[f"{name}.weight"] = torch.randn(width, 64)
    return sd


@pytest.mark.parametrize("heads", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_mistral_decoder_matches_jax(heads, dtype):
    """12 layers (keys ``layers.10`` / ``layers.2``), a 390-row vocabulary
    cut to 384, the heads present or zero-filled."""
    sd = _mistral_sd(heads)
    jcfg = dataclasses.replace(JDecoderConfig.tiny(), num_layers=12)
    tcfg = dataclasses.replace(DecoderConfig.tiny(), num_layers=12)
    want = jconvert.convert_mistral_decoder({k: v.numpy() for k, v in sd.items()}, jcfg,
                                            dtype=getattr(jnp, dtype))
    got = tconvert.convert_mistral_decoder(sd, tcfg, dtype=getattr(torch, dtype))
    assert_trees_equal(got, want)
    assert got["embed"].shape[0] == 384 and got["lm_head"].shape[1] == 384
    assert (got["sync_head"] != 0).any() == heads


@pytest.mark.parametrize("pre_ln", ["pre_layrnorm", "pre_layernorm"])
def test_convert_clip_vision_matches_jax(pre_ln):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf_cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                              num_attention_heads=2, image_size=56, patch_size=14,
                              hidden_act="quick_gelu")
    torch.manual_seed(1)
    sd = {k.replace("pre_layrnorm", pre_ln): v.detach().to(torch.bfloat16)
          for k, v in CLIPVisionModel(hf_cfg).state_dict().items()}
    want = jconvert.convert_clip_vision(
        {k: v.float().numpy() for k, v in sd.items()}, JVisionConfig.tiny(), dtype=jnp.bfloat16)
    got = tconvert.convert_clip_vision(sd, VisionConfig.tiny(), dtype=torch.bfloat16)
    assert_trees_equal(got, want)


def test_convert_connector_and_towers_match_jax():
    rng = np.random.default_rng(3)
    sd = {"model.mm_projector.slots": rng.standard_normal((32, 4)),
          "model.mm_projector.ln_vision.weight": rng.standard_normal(32),
          "model.mm_projector.ln_vision.bias": rng.standard_normal(32),
          "model.mm_projector.readout.weight": rng.standard_normal((64, 32)),
          "model.time_tower.embed_tokens.weight": rng.standard_normal((13, 64)),
          "model.score_tower.embed_tokens.weight": rng.standard_normal((13, 64)),
          "model.sync_tower.embed_tokens.weight": rng.standard_normal((1, 64))}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for jfn, tfn in ((jconvert.convert_spatial_slot, tconvert.convert_spatial_slot),
                     (jconvert.convert_towers, tconvert.convert_towers)):
        assert_trees_equal(tfn(tsd, dtype=torch.bfloat16), jfn(sd, dtype=jnp.bfloat16))


@pytest.mark.parametrize("hf", [
    {},
    {"model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
     "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
     "num_key_value_heads": 8, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
     "mm_projector_type": "spatial_slot", "num_slots": 8, "num_frames": 128},
    {"model_type": "llama", "hidden_size": 512, "num_attention_heads": 8, "head_dim": None,
     "num_frames": 64, "image_aspect_ratio": "square", "time_vocab_size": 13},
])
def test_trace_config_from_hf_matches_jax(hf):
    want = jconvert.trace_config_from_hf(hf, dtype=jnp.bfloat16)
    got = tconvert.trace_config_from_hf(hf, dtype=torch.bfloat16)
    for f in dataclasses.fields(got.decoder):
        if hasattr(want.decoder, f.name):
            assert getattr(got.decoder, f.name) == getattr(want.decoder, f.name), f.name
    assert got.vision == VisionConfig() and want.vision == JVisionConfig()
    for name in ("mm_projector_type", "num_slots", "num_frames", "image_aspect_ratio"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("hf, what", [
    ({"model_type": "mixtral"}, "Mixtral"),
    ({"num_local_experts": 8}, "Mixtral"),
    ({"model_type": "qwen2"}, "qwen2"),
])
def test_other_architectures_raise(hf, what):
    """An unknown projector raises. A qwen2 config converts, with its qkv
    biases, and a Mixtral one (by ``model_type`` or ``num_local_experts``)
    to the JAX package's MoE config in the dense form (both ported since;
    tests/test_torch_families.py and tests/test_torch_moe.py hold them to
    JAX)."""
    got = tconvert.trace_config_from_hf(hf).decoder
    if what == "qwen2":
        assert got.attn_qkv_bias
    else:
        want = jconvert.trace_config_from_hf(hf).decoder
        assert type(got).__name__ == type(want).__name__ == "MoEConfig"
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name, getattr(got, f.name)), f.name
        assert (got.num_experts, got.top_k, got.moe_impl) == (8, 2, "dense")
    cfg = dataclasses.replace(TraceConfig.tiny(), mm_projector_type="resampler")
    with pytest.raises(NotImplementedError, match="resampler"):
        tconvert.convert_connector({}, cfg, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Whole checkpoints and the loader's routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_trace_checkpoint_matches_jax(tmp_path, tiny_vision, dtype):
    """A merged dir in 3 bf16 shards, 6 spare vocabulary rows, no sync and
    score heads (zero-filled)."""
    cfg = jax_config()
    write_merged_checkpoint(tmp_path / "ckpt", cfg, extra_rows=6,
                            drop=("sync_head.weight", "score_head.weight"))
    jp, jc = jconvert.convert_trace_checkpoint(str(tmp_path / "ckpt"), dtype=getattr(jnp, dtype))
    tp, tc = tconvert.convert_trace_checkpoint(str(tmp_path / "ckpt"),
                                               dtype=getattr(torch, dtype))
    assert_trees_equal(tp, jp)
    assert tc.decoder.num_layers == jc.decoder.num_layers == 12
    assert tc.num_frames == jc.num_frames and tc.dtype == getattr(torch, dtype)
    assert not tp["decoder"]["score_head"].any() and tp["decoder"]["time_head"].any()


def test_convert_trace_checkpoint_reads_each_key_once(tmp_path, tiny_vision, monkeypatch):
    """Every key of the manifest is read exactly once; the pre-LN probe and
    the optional heads are membership tests, not reads."""
    cfg = jax_config()
    sd = write_merged_checkpoint(tmp_path / "ckpt", cfg, shards=1)
    reads = {}

    class Recording(dict):
        def __getitem__(self, k):
            reads[k] = reads.get(k, 0) + 1
            return super().__getitem__(k)

    load = tconvert.load_checkpoint_tensors
    monkeypatch.setattr(tconvert, "load_checkpoint_tensors", lambda p: Recording(load(p)))
    tconvert.convert_trace_checkpoint(str(tmp_path / "ckpt"), dtype=torch.bfloat16)
    assert reads == dict.fromkeys(sd, 1)


def test_vision_from_vision_path(tmp_path, tiny_vision):
    cfg = jax_config()
    sd = write_merged_checkpoint(tmp_path / "ckpt", cfg, shards=2)
    vis = "model.vision_tower.vision_tower.vision_model."
    merged = tmp_path / "novis"
    merged.mkdir()
    save_torch({k: v for k, v in sd.items() if not k.startswith(vis)},
               str(merged / "model.safetensors"))
    (merged / "config.json").write_text(json.dumps(hf_config_of(cfg)))
    clip = tmp_path / "clip"
    clip.mkdir()
    save_torch({"vision_model." + k[len(vis):]: v for k, v in sd.items() if k.startswith(vis)},
               str(clip / "model.safetensors"))
    with pytest.raises(FileNotFoundError, match="vision_path"):
        tconvert.convert_trace_checkpoint(str(merged))
    want, _ = jconvert.convert_trace_checkpoint(str(merged), vision_path=str(clip))
    got, _ = tconvert.convert_trace_checkpoint(str(merged), vision_path=str(clip))
    assert_trees_equal(got, want)


def _lora_adapter(sd, rng, r=4):
    """PEFT adapter tensors on two projections of layers 0 and 11."""
    adapter = {}
    for i in (0, 11):
        for proj in ("self_attn.q_proj", "mlp.down_proj"):
            out_f, in_f = sd[f"model.layers.{i}.{proj}.weight"].shape
            base = f"base_model.model.model.layers.{i}.{proj}"
            adapter[f"{base}.lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((r, in_f)).astype(np.float32))
            adapter[f"{base}.lora_B.weight"] = torch.from_numpy(
                rng.standard_normal((out_f, r)).astype(np.float32) * 0.1)
    return adapter


@pytest.mark.parametrize("adapter_format", ["safetensors", "bin"])
def test_load_pretrained_lora_route_matches_jax(tmp_path, tiny_vision, adapter_format):
    """LoRA with a base: non_lora_trainables.bin over the base, the adapter
    merged in fp32; merged leaves within LORA_TOL, the rest bit for bit."""
    cfg = jax_config()
    sd = write_merged_checkpoint(tmp_path / "base", cfg, dtype=torch.float32)
    run = tmp_path / "trace-lora-run"
    run.mkdir()
    rng = np.random.default_rng(4)
    adapter = _lora_adapter(sd, rng)
    if adapter_format == "safetensors":
        save_torch(adapter, str(run / "adapter_model.safetensors"))
    else:
        torch.save(adapter, run / "adapter_model.bin")
    (run / "adapter_config.json").write_text(json.dumps({"lora_alpha": 16, "r": 4}))
    torch.save({"model.mm_projector.slots": torch.randn(32, 4),
                "time_head.weight": torch.randn(13, 64)}, run / "non_lora_trainables.bin")
    want, wc = jloader.load_pretrained(str(run), str(tmp_path / "base"), dtype=jnp.float32)
    got, gc = tloader.load_pretrained(str(run), str(tmp_path / "base"), dtype=torch.float32)
    assert_trees_equal(got, want, close={"decoder/layers/wq", "decoder/layers/w_down"})
    base, _ = tconvert.convert_trace_checkpoint(str(tmp_path / "base"), dtype=torch.float32)
    assert not torch.equal(got["decoder"]["layers"]["wq"], base["decoder"]["layers"]["wq"])
    assert torch.equal(got["connector"]["slots"],
                       torch.load(run / "non_lora_trainables.bin")["model.mm_projector.slots"])
    assert gc.decoder.num_layers == wc.decoder.num_layers


def test_load_pretrained_base_projector_and_merged_routes(tmp_path, tiny_vision):
    cfg = jax_config()
    write_merged_checkpoint(tmp_path / "base", cfg)
    run = tmp_path / "stage1"
    run.mkdir()
    torch.save({"model.mm_projector.slots": torch.randn(32, 4).to(torch.bfloat16),
                "model.mm_projector.readout.weight": torch.randn(64, 32)},
               run / "mm_projector.bin")
    for args in ((str(run), str(tmp_path / "base")), (str(tmp_path / "base"), None)):
        want, _ = jloader.load_pretrained(*args)
        got, gc = tloader.load_pretrained(*args)
        assert_trees_equal(got, want)
        assert gc.dtype == torch.bfloat16


def test_merge_lora_weights_matches_jax():
    rng = np.random.default_rng(5)
    base = {"model.layers.0.self_attn.q_proj.weight": rng.standard_normal((8, 6)),
            "model.norm.weight": np.ones(6)}
    adapter = {
        "base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight":
            rng.standard_normal((2, 6)),
        "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight":
            rng.standard_normal((8, 2)),
        "base_model.model.model.layers.0.self_attn.q_proj.lora_A.extra": np.zeros(1),
    }
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    want = jloader.merge_lora_weights(f32(base), f32(adapter), 16, 2)
    got = tloader.merge_lora_weights({k: torch.from_numpy(v) for k, v in f32(base).items()},
                                     {k: torch.from_numpy(v) for k, v in f32(adapter).items()},
                                     16, 2)
    assert_trees_equal(got, want, close={"model.layers.0.self_attn.q_proj.weight"})
    with pytest.raises(KeyError, match="not in base"):
        tloader.merge_lora_weights({}, {k: torch.from_numpy(v) for k, v in f32(adapter).items()},
                                   16, 2)


@pytest.mark.parametrize("path", ["runs/trace-7b/", "/ckpt/checkpoint-200", "trace"])
def test_model_name_from_path_matches_jax(path):
    assert tloader.get_model_name_from_path(path) == jloader.get_model_name_from_path(path)


# ---------------------------------------------------------------------------
# Stage-0 assembly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_dirs(tmp_path_factory):
    from transformers import (CLIPVisionConfig, CLIPVisionModel, MistralConfig,
                              MistralForCausalLM)

    root = tmp_path_factory.mktemp("bases")
    torch.manual_seed(0)
    MistralForCausalLM(MistralConfig(
        vocab_size=384, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=512, rms_norm_eps=1e-5, sliding_window=None,
        tie_word_embeddings=False)).save_pretrained(root / "llm")
    torch.manual_seed(1)
    CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
        image_size=56, patch_size=14, hidden_act="quick_gelu")).save_pretrained(root / "clip")
    return str(root / "llm"), str(root / "clip")


def test_build_from_base_models_matches_jax(base_dirs, tmp_path):
    """Converted leaves bit for bit; the fresh ones (heads, connector, towers:
    JAX's PRNG cannot be matched) by shape, dtype and non-zero values; a
    stage-1 projector resumes the connector bit for bit."""
    llm, clip = base_dirs
    want, wc = jconvert.build_from_base_models(llm, clip, vision=JVisionConfig.tiny(),
                                               dtype=jnp.float32)
    got, gc = tconvert.build_from_base_models(llm, clip, vision=VisionConfig.tiny(),
                                              dtype=torch.float32,
                                              generator=torch.Generator().manual_seed(0))
    fresh = {"decoder/sync_head", "decoder/time_head", "decoder/score_head",
             "connector/slots", "connector/readout"}
    fresh |= {p for p in _leaves(want) if p.startswith("towers/")}
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for name in w:
        if name in fresh:
            assert g[name].shape == w[name].shape and g[name].dtype == torch.float32
            assert g[name].abs().max() > 0, name
    assert_trees_equal({k: v for k, v in g.items() if k not in fresh},
                       {k: v for k, v in w.items() if k not in fresh})
    for f in dataclasses.fields(gc.decoder):
        if hasattr(wc.decoder, f.name):
            assert getattr(gc.decoder, f.name) == getattr(wc.decoder, f.name), f.name
    conn = got["connector"]
    torch.save({"slots": conn["slots"], "ln_vision.weight": conn["ln_scale"],
                "ln_vision.bias": conn["ln_bias"],
                "readout.weight": conn["readout"].t().contiguous()}, tmp_path / "proj.bin")
    resumed, _ = tconvert.build_from_base_models(
        llm, clip, vision=VisionConfig.tiny(), dtype=torch.float32,
        mm_projector_path=str(tmp_path / "proj.bin"))
    assert_trees_equal(resumed["connector"], conn)
    assert_trees_equal(resumed["connector"], jconvert.load_mm_projector(
        str(tmp_path / "proj.bin"), wc, dtype=jnp.float32))
