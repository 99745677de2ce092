"""The port's tensor-parallel serving and expert parallelism against the JAX
package's, on the tiny config: four ranks of a gloo group on the CPU
(``_torch_mp_worker.py serve``, spawned once for the module) against JAX's
GSPMD on its 8 virtual CPU devices, with the same weights and inputs.

* ``generate_sharded``: tokens and ``num_generated`` equal JAX's
  ``generate_sharded`` on ``build_mesh(8, model_axis=2)``, greedy and
  time-constrained, fp32 and int8 (the fused int8 serving tree with W8A8
  prefill and the int8 KV cache), on a (data 2, model 2) mesh and on a
  (1, 4) mesh: at model 4 the tiny model's 4 q heads shard and its 2 kv
  heads do not (the mixed placement of JAX's divisibility rule; in the int8
  tree's flattened k / v leaves the shares are half heads, which the port
  gathers). JAX's tokens do not depend on its mesh (its own tests hold them
  to one device), so one JAX mesh serves both. An int4p tree raises
  ``ValueError`` with JAX's text in both packages, on JAX's (4, 2) and
  (2, 4) meshes.
* ``encode_prefix_sharded`` within JAX's rtol 2e-4, atol 2e-5 of JAX's on
  its (4, 2) mesh and of the unsharded encode (tests/test_sharded_generate.py).
* Expert-parallel ``moe_mlp``, one expert a rank, dense and sparse, within
  rtol 2e-5, atol 2e-6 of JAX's layer placed by hand (tests/test_moe.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mp_worker import run_ranks
from trace_tpu.model import moe as jmoe
from trace_tpu.model import quantize as jq
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.trace_model import init_trace_params, tokens_per_frame
from trace_tpu.runtime import generate as jgen
from trace_tpu.runtime.mesh import build_mesh, shard_params_for_inference
from trace_tpu.runtime.pipeline import (
    TracePipeline,
    _encode_prefix_jit,
    encode_prefix_sharded,
    expand_prompt_ids,
)
from trace_tpu.tokenizers.event_codec import TIME_CODEC
from trace_tpu.tokenizers.text import ByteTokenizer
from trace_tpu_torch.params import from_jax_params

JCFG = JTraceConfig.tiny()
B = 4
GREEDY = dict(max_new_tokens=16, initial_head=1, eos_id=-5)
MESHES = {"m2": 2, "m4": 4}  # the model axis of the port's 4-rank meshes


def _t(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _fids(T):
    return np.stack([np.stack([TIME_CODEC.encode_value(float(i)) for i in range(T)])] * B
                    ).astype(np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's results and the port's, rank by rank."""
    params = init_trace_params(JCFG, jax.random.PRNGKey(0))
    pipe = TracePipeline(params=params, config=JCFG, tokenizer=ByteTokenizer())
    pipe._prepare_memory_layout()
    T = JCFG.num_frames
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (T, 56, 56, 3), dtype=np.uint8) for _ in range(B)]
    prefix, mask = pipe._prepare_prefix_batch(
        frames, [[[float(i)] for i in range(T)]] * B, [f"question {b}" for b in range(B)])
    dec = pipe._decoder_params
    int8 = jq.fuse_decoder_serving(jq.quantize_decoder_params(dec))
    int4p = jq.quantize_decoder_params(dec, bits=4, pack=True)
    int8_cfg = dataclasses.replace(JCFG.decoder, act_quant=True, kv_cache_dtype="int8")
    fids = _fids(T)
    constrained = dict(max_new_tokens=12, initial_head=1, eos_id=-5, constrain_time=True,
                       frame_time_ids=jnp.asarray(fids))

    # the encode's inputs (tests/test_sharded_generate.py)
    from trace_tpu import conversation as conv
    from trace_tpu.tokenizers.text import splice_modal_tokens

    spliced = splice_modal_tokens(conv.build_trace_prompt("what happens"), pipe.tokenizer)
    ids, vp = expand_prompt_ids(spliced, T * tokens_per_frame(JCFG), JCFG.decoder.vocab_size)
    token_ids = np.stack([ids] * B).astype(np.int32)
    video_pos = np.asarray([vp] * B, np.int32)
    enc_frames = np.asarray(np.random.default_rng(1).normal(
        size=(B, T, JCFG.vision.image_size, JCFG.vision.image_size, 3)), np.float32)

    # one MoE layer and its input (tests/test_moe.py)
    mcfg = jmoe.MoEConfig.tiny_moe()
    lp = {k: v[0] for k, v in jmoe.init_moe_mlp_params(mcfg, jax.random.PRNGKey(6)).items()}
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 8, mcfg.hidden_size)) * 0.1

    want = {}
    mesh = build_mesh(8, model_axis=2)
    for tree, tp, c in (("fp32", dec, JCFG.decoder), ("int8", int8, int8_cfg)):
        sp = shard_params_for_inference(tp, mesh)
        for kind, kw in (("greedy", GREEDY), ("constrained", constrained)):
            g = jgen.generate_sharded(sp, c, prefix, mask, pipe._combined, mesh=mesh, **kw)
            want[f"{tree}/{kind}"] = (g.tokens, g.num_generated)
    want["encode"] = np.asarray(encode_prefix_sharded(
        pipe._encode_params, JCFG, jnp.asarray(token_ids), jnp.asarray(video_pos),
        jnp.asarray(enc_frames), jnp.asarray(fids), pipe._combined, mesh), np.float32)
    for mname, m in MESHES.items():
        with pytest.raises(ValueError) as e:
            jgen.generate_sharded(int4p, JCFG.decoder, prefix, mask, pipe._combined,
                                  mesh=build_mesh(8, model_axis=m), **GREEDY)
        want[f"{mname}/int4p"] = str(e.value)
    want["encode_unsharded"] = np.asarray(_encode_prefix_jit(
        pipe._encode_params, JCFG, jnp.asarray(token_ids), jnp.asarray(video_pos),
        jnp.asarray(enc_frames), jnp.asarray(fids), pipe._combined, False), np.float32)
    mesh = build_mesh(8)  # model 4, 4 experts: one a shard
    spec = {"router": P(), "w_gate": P("model", None, None), "w_up": P("model", None, None),
            "w_down": P("model", None, None)}
    slp = {k: jax.device_put(v, NamedSharding(mesh, spec[k])) for k, v in lp.items()}
    for form in ("dense", "sparse"):
        fcfg = dataclasses.replace(mcfg, moe_impl=form)
        with mesh:
            want[f"moe/{form}"] = np.asarray(jax.jit(
                lambda xx, pp, c=fcfg: jmoe.moe_mlp(xx, pp, c))(x, slp))

    inputs = {
        "fp32": _t(dec), "int8": _t(int8), "int4p": _t(int4p),
        "combined": torch.from_numpy(np.array(pipe._combined)),
        "prefix": torch.from_numpy(np.array(prefix)),
        "mask": torch.from_numpy(np.array(mask)),
        "fids": torch.from_numpy(fids),
        "encode": {"params": _t(pipe._encode_params), "token_ids": torch.from_numpy(token_ids),
                   "video_pos": torch.from_numpy(video_pos),
                   "frames": torch.from_numpy(enc_frames), "fids": torch.from_numpy(fids)},
        "moe": {"lp": _t(lp), "x": torch.from_numpy(np.array(x))},
    }
    got = run_ranks("serve", inputs, 4, tmp_path_factory.mktemp("serve"))
    return want, got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
@pytest.mark.parametrize("kind", ["greedy", "constrained"])
def test_generate_sharded_tokens_equal_jax(run, mesh, tree, kind):
    want, got = run
    w_tokens, w_num = want[f"{tree}/{kind}"]
    for rank, out in enumerate(got):  # every rank returns the whole batch
        tokens, num = out[f"{mesh}/{tree}/{kind}"]
        np.testing.assert_array_equal(tokens, np.asarray(w_tokens), err_msg=f"rank {rank}")
        np.testing.assert_array_equal(num, np.asarray(w_num), err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_int4p_is_refused_as_in_jax(run, mesh):
    want, got = run
    assert "single-chip only" in want[f"{mesh}/int4p"]
    for out in got:
        assert out[f"{mesh}/int4p"] == want[f"{mesh}/int4p"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_encode_prefix_sharded_matches_jax(run, mesh):
    want, got = run
    for out in got:
        enc = out[f"{mesh}/encode"].float().numpy()
        np.testing.assert_allclose(enc, want["encode"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(enc, want["encode_unsharded"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_expert_parallel_moe_matches_jax(run, form):
    want, got = run
    for out in got:
        np.testing.assert_allclose(out[f"moe/{form}"].numpy(), want[f"moe/{form}"],
                                   rtol=2e-5, atol=2e-6)


def test_meshes_lay_ranks_out_as_jax(run):
    """Rank r of the (2, 2) mesh sits at (r // 2, r % 2), of (1, 4) at (0, r):
    JAX's row-major reshape of the device list."""
    _, got = run
    for r, out in enumerate(got):
        assert out["coords"]["m2"] == ({"data": r // 2, "model": r % 2}, {"data": 2, "model": 2})
        assert out["coords"]["m4"] == ({"data": 0, "model": r}, {"data": 1, "model": 4})
