"""Tensor-parallel serving of the native int4 tree (``quant="int4"``) against
the JAX package's, on the tiny config.

The JAX package shards its ``jnp.int4`` leaves by the int8 rules; the port
holds the same values nibble-packed per output channel (``int4_serving``)
and ``shard_params_for_inference`` places them as their int4 values, then
packs each rank's shard on the rank (a byte pairs rows k and k + K / 2 of
the weight it holds, so a row-parallel shard packs within its local K).

* ``generate_sharded``: tokens and ``num_generated`` equal JAX's
  ``generate_sharded`` on ``build_mesh(8, model_axis=2)`` over its native
  int4 tree, greedy and time-constrained, with the port's four ranks of a
  gloo group on a (data 2, model 2) mesh (this file run as a script is the
  rank worker; it imports no JAX).
* The placement alone, for each rank of a 2-rank model axis: the packed
  shards unpack to the rank's block of the whole weight.
* An int4p tree (group-scaled here) is still refused, and the message names
  only the formats that shard.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
GREEDY = dict(max_new_tokens=16, initial_head=1, eos_id=-5)
WORLD = 4


def _port_int4(jtree) -> dict:
    """The JAX package's native int4 decoder as ``int4_serving`` holds it:
    every layer weight packed per output channel in the flattened [L, K, N]
    view with [L, 1, N] scales, then fused."""
    from trace_tpu_torch.model.quantize import fuse_decoder_serving, pack4

    layers = dict(jtree["layers"])
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        q, sc = layers[name]["q"], layers[name]["s"]
        L, N = q.shape[0], sc[0].numel()
        layers[name] = {"qp": pack4(q.reshape(L, -1, N)), "s": sc.reshape(L, 1, N)}
    return fuse_decoder_serving({**jtree, "layers": layers})


def _fids(T):
    from trace_tpu.tokenizers.event_codec import TIME_CODEC

    return np.stack([np.stack([TIME_CODEC.encode_value(float(i)) for i in range(T)])] * B
                    ).astype(np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's tokens and the port's, rank by rank."""
    import jax
    import jax.numpy as jnp

    from trace_tpu.model import quantize as jq
    from trace_tpu.model.config import TraceConfig as JTraceConfig
    from trace_tpu.model.trace_model import init_trace_params
    from trace_tpu.runtime import generate as jgen
    from trace_tpu.runtime.mesh import build_mesh, shard_params_for_inference
    from trace_tpu.runtime.pipeline import TracePipeline
    from trace_tpu.tokenizers.text import ByteTokenizer
    from trace_tpu_torch.params import from_jax_params

    jcfg = JTraceConfig.tiny()
    params = init_trace_params(jcfg, jax.random.PRNGKey(0))
    pipe = TracePipeline(params=params, config=jcfg, tokenizer=ByteTokenizer())
    pipe._prepare_memory_layout()
    T = jcfg.num_frames
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (T, 56, 56, 3), dtype=np.uint8) for _ in range(B)]
    prefix, mask = pipe._prepare_prefix_batch(
        frames, [[[float(i)] for i in range(T)]] * B, [f"question {b}" for b in range(B)])
    int4 = jq.quantize_decoder_params(pipe._decoder_params, bits=4)
    assert np.asarray(int4["layers"]["wq"]["q"]).dtype.name == "int4"
    int4_cfg = dataclasses.replace(jcfg.decoder, act_quant=False, kv_cache_dtype="int8")
    fids = _fids(T)
    constrained = dict(max_new_tokens=12, initial_head=1, eos_id=-5, constrain_time=True,
                       frame_time_ids=jnp.asarray(fids))
    mesh = build_mesh(8, model_axis=2)
    sp = shard_params_for_inference(int4, mesh)
    want = {}
    for kind, kw in (("greedy", GREEDY), ("constrained", constrained)):
        g = jgen.generate_sharded(sp, int4_cfg, prefix, mask, pipe._combined, mesh=mesh, **kw)
        want[kind] = (np.asarray(g.tokens), np.asarray(g.num_generated))
    inputs = {"int4": _port_int4(from_jax_params(jax.tree.map(np.asarray, int4))),
              "combined": torch.from_numpy(np.array(pipe._combined)),
              "prefix": torch.from_numpy(np.array(prefix)),
              "mask": torch.from_numpy(np.array(mask)),
              "fids": torch.from_numpy(fids)}
    return want, _run_ranks(inputs, tmp_path_factory.mktemp("int4_serve"))


def _run_ranks(inputs: dict, tmp_path) -> list:
    """This file as the rank worker, WORLD ranks of a gloo group."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_mp_worker import free_port

    inp = os.path.join(str(tmp_path), "inputs.pt")
    torch.save(inputs, inp)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port),
         "--inp", inp, "--out", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} did not finish in 300 s")
        if p.returncode:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _rank_task(inp: dict) -> dict:
    """One rank: the int4 tree placed on a (2, 2) mesh, generate_sharded
    greedy and constrained; the local shapes of the packed shards."""
    from trace_tpu_torch.model.config import DecoderConfig
    from trace_tpu_torch.runtime.generate import generate_sharded
    from trace_tpu_torch.runtime.mesh import build_mesh, shard_params_for_inference

    cfg = dataclasses.replace(DecoderConfig.tiny(), kv_cache_dtype="int8", native_int4=True)
    mesh = build_mesh(WORLD, model_axis=2, device="cpu")
    params = shard_params_for_inference(inp["int4"], mesh)
    out = {"shapes": {n: tuple(leaf["qp"].shape) for n, leaf in params["layers"].items()
                      if isinstance(leaf, dict) and "qp" in leaf}}
    constrained = dict(max_new_tokens=12, initial_head=1, eos_id=-5, constrain_time=True,
                       frame_time_ids=inp["fids"])
    for kind, kw in (("greedy", GREEDY), ("constrained", constrained)):
        g = generate_sharded(params, cfg, inp["prefix"], inp["mask"], inp["combined"],
                             mesh=mesh, **kw)
        out[kind] = (g.tokens, g.num_generated)
    return out


@pytest.mark.parametrize("kind", ["greedy", "constrained"])
def test_generate_sharded_int4_tokens_equal_jax(run, kind):
    want, got = run
    w_tokens, w_num = want[kind]
    for rank, out in enumerate(got):  # every rank returns the whole batch
        tokens, num = out[kind]
        np.testing.assert_array_equal(tokens, w_tokens, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(num, w_num, err_msg=f"rank {rank}")


def test_int4_shards_are_packed_within_the_local_k(run):
    """Model 2 of the tiny decoder (4 q / 2 kv heads of 16, D 64, I 128):
    column shares halve N, row shares (wo, w_down) halve K, each packed to
    half its local rows."""
    _, got = run
    for out in got:
        s = out["shapes"]
        assert s["wq"] == (2, 32, 32) and s["wk"] == s["wv"] == (2, 32, 16)
        assert s["wo"] == (2, 16, 64) and s["w_down"] == (2, 32, 64)
        assert s["w_gate"] == s["w_up"] == (2, 32, 64)


def _tiny_int4_tree(seed: int = 3) -> dict:
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import quantize_decoder_params
    from trace_tpu_torch.params import init_trace_params

    dec = init_trace_params(TraceConfig.tiny(), torch.Generator().manual_seed(seed))["decoder"]
    return quantize_decoder_params(dec, bits=4, pack=True, group=0)


@pytest.mark.parametrize("fused", [False, True])
def test_int4_placement_unpacks_to_each_ranks_block(fused):
    """Each rank of a model axis of 2 (a mesh that only places): its packed
    shard of every layer weight, unpacked, is its block of the whole weight
    unpacked; the scales follow the columns."""
    from trace_tpu_torch.model.quantize import fuse_decoder_serving, unpack4
    from trace_tpu_torch.runtime.mesh import Mesh, shard_params_for_inference

    tree = _tiny_int4_tree()
    whole = tree["layers"]
    served = fuse_decoder_serving(tree) if fused else tree
    rows = {"wo", "w_down"}  # row-parallel: K shared; the others: N
    for r in range(2):
        mesh = Mesh(("data", "model"), (1, 2), coords={"data": 0, "model": r})
        local = shard_params_for_inference(served, mesh)["layers"]
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            w = unpack4(whole[name]["qp"])  # [L, K, N]
            K, N = w.shape[1:]
            got = unpack4(local[name]["qp"])
            if name in rows:
                want, s = w[:, r * K // 2:(r + 1) * K // 2], whole[name]["s"]
            else:
                want = w[:, :, r * N // 2:(r + 1) * N // 2]
                s = whole[name]["s"][..., r * N // 2:(r + 1) * N // 2]
            assert torch.equal(got, want), (name, r)
            assert torch.equal(local[name]["s"], s), (name, r)


def test_int4p_refusal_names_only_formats_that_shard():
    """A group-scaled packed tree raises before any collective, native int4
    config or not, and the message recommends int8 and int4 alone."""
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.quantize import quantize_decoder_params
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.runtime.generate import generate_sharded

    tiny = TraceConfig.tiny()
    cfg = dataclasses.replace(tiny.decoder, hidden_size=256, intermediate_size=256)
    dec = init_trace_params(dataclasses.replace(tiny, decoder=cfg),
                            torch.Generator().manual_seed(4))["decoder"]
    grouped = quantize_decoder_params(dec, bits=4, pack=True, group=128)
    assert grouped["layers"]["wq"]["s"].shape[1] == 2
    for c in (cfg, dataclasses.replace(cfg, native_int4=True)):
        with pytest.raises(ValueError) as e:
            generate_sharded(grouped, c, None, None, None, mesh=None)
        named = re.findall(r"'(\w+)'", str(e.value))
        assert named == ["int8", "int4"], str(e.value)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from trace_tpu_torch.runtime.distributed import initialize

    initialize(f"localhost:{args.port}", WORLD, args.rank, backend="gloo")
    with torch.no_grad():
        out = _rank_task(torch.load(args.inp, weights_only=False))
    if any(m in sys.modules for m in ("jax", "trace_tpu")):
        raise RuntimeError("a rank imported JAX or the JAX package")
    torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
