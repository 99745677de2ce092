"""The port's mesh rules and multi-process integers against the JAX
package's (trace_tpu/runtime/mesh.py, distributed.py, parallel/pipeline.py):

* ``param_spec`` gives, for every leaf, the axis names of JAX's
  ``PartitionSpec`` on meshes (data, model) = (2, 4), (4, 2), (1, 2), (1, 4):
  the tiny fp32, int8, fused-int8 and int4p trees, a qwen2-style tree with
  q / k / v biases, a tiny Mixtral tree, a tree with LoRA adapters on every
  projection (rank 6: sharded on r at model 2, not at 4) and the full
  TRACE-7B shapes (stub leaves with only a shape); so do
  ``inference_param_shardings`` and ``batch_shardings``;
* ``build_mesh``'s axis sizes, ``process_order_shard``,
  ``split_layers_into_stages`` and ``initialize``'s no-op and its
  explicit-then-environment precedence equal JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.model import moe as jmoe
from trace_tpu.model import quantize as jq
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.lora import add_lora_params
from trace_tpu.model.trace_model import init_trace_params
from trace_tpu.parallel import pipeline as jpp
from trace_tpu.runtime import distributed as jdist
from trace_tpu.runtime import mesh as jmesh
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.parallel import pipeline as tpp
from trace_tpu_torch.runtime import distributed as tdist
from trace_tpu_torch.runtime import mesh as tmesh

MESHES = ((2, 4), (4, 2), (1, 2), (1, 4))


@pytest.fixture(scope="module")
def jax_meshes():
    return {(d, m): jmesh.build_mesh(d * m, model_axis=m) for d, m in MESHES}


def _jax_specs(tree, mesh, fn=None):
    """{path: spec as a tuple} of a JAX tree (or a tree of spec objects)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree if fn is None else fn(tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    out = {}
    for path, leaf in flat:
        spec = leaf.spec if fn is not None else jmesh.param_spec(path, leaf, mesh)
        out[jmesh._path_str(path)] = tuple(spec)
    return out


def _trees():
    cfg = JTraceConfig.tiny()
    base = init_trace_params(cfg, jax.random.PRNGKey(0))
    dec = base["decoder"]
    qwen_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, attn_qkv_bias=True))
    lora_dec = dataclasses.replace(cfg.decoder, lora_r=6)
    lora = {**base, "decoder": add_lora_params(
        dec, lora_dec, jax.random.PRNGKey(3),
        targets=("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))}
    moe = dict(base)
    moe["decoder"] = jmoe.init_moe_decoder_params(jmoe.MoEConfig.tiny_moe(),
                                                  jax.random.PRNGKey(1))
    return {
        "fp32": base,
        "int8": {**base, "decoder": jq.quantize_decoder_params(dec)},
        "fused_int8": {**base, "decoder": jq.fuse_decoder_serving(
            jq.quantize_decoder_params(dec))},
        "int4p": {**base, "decoder": jq.quantize_decoder_params(dec, bits=4, pack=True)},
        "qwen2": init_trace_params(qwen_cfg, jax.random.PRNGKey(2)),
        "mixtral": moe,
        "lora": lora,
    }


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ["fp32", "int8", "fused_int8", "int4p", "qwen2", "mixtral",
                                  "lora"])
def test_param_spec_matches_jax(jax_meshes, trees, name, mesh):
    tree = trees[name]
    want = _jax_specs(tree, jax_meshes[mesh])
    port_mesh = tmesh.Mesh(("data", "model"), mesh)
    got = {path: tmesh.param_spec(path, leaf, port_mesh)
           for path, leaf in tmesh._leaves(from_jax_params(jax.tree.map(np.asarray, tree)))}
    assert got == want
    assert any(any(s) for s in got.values())  # something shards
    # serving placement: decoder TP, the rest replicated
    want = _jax_specs(tree, jax_meshes[mesh], jmesh.inference_param_shardings)
    got = dict(tmesh._leaves(tmesh.inference_param_shardings(
        from_jax_params(jax.tree.map(np.asarray, tree)), port_mesh)))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_param_spec_matches_jax_at_trace_7b_shapes(jax_meshes, mesh):
    """The full TRACE-7B tree's shapes (no values: stub leaves)."""
    stubs = jax.eval_shape(lambda k: init_trace_params(JTraceConfig(), k),
                           jax.random.PRNGKey(0))
    want = _jax_specs(stubs, jax_meshes[mesh])
    port_mesh = tmesh.Mesh(("data", "model"), mesh)
    got = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(stubs)[0]:
        got[jmesh._path_str(path)] = tmesh.param_spec(
            "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path), leaf,
            port_mesh)
    assert got == want
    assert got["decoder/layers/wq"] == (None, None, "model", None)
    assert got["decoder/embed"] == ("model", None)


def test_batch_shardings_match_jax(jax_meshes):
    batch = {"frames": 0, "frame_time_ids": 0, "token_ids": 0, "labels": 0}
    want = {k: tuple(v.spec) for k, v in
            jmesh.batch_shardings(jax_meshes[(2, 4)], batch).items()}
    assert tmesh.batch_shardings(tmesh.Mesh(("data", "model"), (2, 4)), batch) == want


def test_shard_batch_takes_the_ranks_rows_and_frames():
    batch = {"frames": torch.arange(4 * 8).reshape(4, 8), "token_ids": torch.arange(4)}
    m = tmesh.Mesh(("data", "model"), (2, 4), coords={"data": 1, "model": 2})
    got = tmesh.shard_batch(batch, m)
    assert got["frames"].tolist() == [[20, 21], [28, 29]]
    assert got["token_ids"].tolist() == [2, 3]


@pytest.mark.parametrize("n,model_axis", [(n, m) for n in (1, 2, 3, 4, 6, 8)
                                          for m in (None, 1, 2, 3, 4) if m is None or m <= n])
def test_build_mesh_axis_sizes_match_jax(n, model_axis):
    want = dict(jmesh.build_mesh(n, model_axis=model_axis).shape)
    assert tmesh.mesh_sizes(n, model_axis) == (want["data"], want["model"])


@pytest.mark.parametrize("n_order,batch,count", [(12, 4, 2), (13, 6, 3), (8, 8, 4), (5, 2, 1)])
def test_process_order_shard_matches_jax(n_order, batch, count):
    order = list(np.random.default_rng(n_order).permutation(n_order))
    for index in range(count):
        assert tdist.process_order_shard(order, batch, index=index, count=count) == \
            jdist.process_order_shard(order, batch, index=index, count=count)
    # one process: the whole order
    assert tdist.process_order_shard(order, batch) == jdist.process_order_shard(order, batch)
    assert tdist.local_batch_size(batch) == jdist.local_batch_size(batch)
    assert (tdist.process_index(), tdist.process_count(), tdist.is_primary()) == (
        jdist.process_index(), jdist.process_count(), jdist.is_primary())


def test_split_layers_into_stages_matches_jax():
    cfg = dataclasses.replace(JTraceConfig.tiny().decoder, num_layers=4)
    from trace_tpu.model.mistral import init_decoder_params

    layers = init_decoder_params(cfg, jax.random.PRNGKey(0))["layers"]
    layers = jq.quantize_decoder_params({"layers": layers, "lm_head": jnp.zeros((2, 2))})[
        "layers"]
    for stages in (1, 2, 4):
        want = jpp.split_layers_into_stages(layers, stages)
        got = tpp.split_layers_into_stages(from_jax_params(jax.tree.map(np.asarray, layers)),
                                           stages)
        jflat = {jmesh._path_str(p): np.asarray(v)
                 for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        tflat = dict(tmesh._leaves(got))
        assert set(jflat) == set(tflat)
        for path, v in jflat.items():
            np.testing.assert_array_equal(tflat[path].float().numpy(), v.astype(np.float32),
                                          err_msg=path)


_ENV = ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES", "WORLD_SIZE",
        "PROCESS_ID", "RANK", "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
        "TPU_WORKER_ID")


@pytest.mark.parametrize("args,env", [
    ((), {}),
    ((), {"MASTER_ADDR": "h", "MASTER_PORT": "9", "WORLD_SIZE": "3", "RANK": "2"}),
    ((), {"COORDINATOR_ADDRESS": "c:1", "MASTER_ADDR": "h", "MASTER_PORT": "9",
          "NUM_PROCESSES": "4", "WORLD_SIZE": "3", "PROCESS_ID": "1", "RANK": "2"}),
    (("x:5", 2, 0), {"COORDINATOR_ADDRESS": "c:1", "NUM_PROCESSES": "4", "PROCESS_ID": "1"}),
    (("x:5", 1, 0), {}),
    ((), {"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "h", "MASTER_PORT": "9"}),
], ids=["none", "torchrun", "explicit-env-wins", "args-win", "one-process", "world-of-one"])
def test_initialize_precedence_matches_jax(monkeypatch, args, env):
    """What each package hands its runtime (or that it does nothing)."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(
        jax=(kw["coordinator_address"], kw["num_processes"], kw["process_id"])))
    monkeypatch.setattr(tdist.dist, "init_process_group", lambda backend, **kw: seen.update(
        port=(kw["init_method"].removeprefix("tcp://"), kw["world_size"], kw["rank"],
              backend)))
    jdist.initialize(*args)
    tdist.initialize(*args)
    if "jax" in seen:
        assert seen["port"] == seen["jax"] + ("gloo",)
    else:
        assert "port" not in seen
    assert tdist.process_count() == 1  # nothing was joined
