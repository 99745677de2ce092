"""The port's pipeline-parallel decoder and train step against the JAX
package's, on the tiny config: four ranks of a gloo group on the CPU
(``_torch_mp_worker.py pp``, spawned once for the module) against JAX on
its 8 virtual CPU devices, with the same weights and batches.

* ``pp_decoder_forward`` at (stages, microbatches) (4, 2), (2, 4), (1, 2)
  within 2e-5 of JAX's ``decoder_forward``; one pipelined SGD train step (4
  stages, 2 microbatches, remat) within rtol 1e-4 of JAX's pipelined step's
  loss, its updated params within rtol 5e-4, atol 5e-5
  (tests/test_pipeline_parallel.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_mp_worker import run_ranks
from trace_tpu.model.config import DecoderConfig as JDecoderConfig
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.config import VisionConfig as JVisionConfig
from trace_tpu.model.mistral import decoder_forward, init_decoder_params
from trace_tpu.model.trace_model import init_trace_params, tokens_per_frame
from trace_tpu.parallel.pipeline import build_pp_mesh
from trace_tpu.train import train as jtrain
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.train.train import tree_paths

PP_CASES = ((4, 2), (2, 4), (1, 2))


def _t(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _pp_step_config():
    return JTraceConfig(decoder=dataclasses.replace(JDecoderConfig.tiny(), num_layers=4),
                        vision=JVisionConfig.tiny(), num_slots=4, num_frames=4,
                        dtype=jnp.float32)


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    cfg = dataclasses.replace(JDecoderConfig.tiny(), num_layers=4)
    params = init_decoder_params(cfg, jax.random.PRNGKey(0))
    B, T = 4, 16
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, cfg.hidden_size)) * 0.1
    mask = jnp.ones((B, T), bool).at[0, -3:].set(False)
    pos = jnp.maximum(jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1, 0)
    want = {"fwd": np.asarray(decoder_forward(params, cfg, x, mask, pos)[0])}

    # the pipelined train step of tests/test_pipeline_parallel.py
    tcfg = _pp_step_config()
    tparams = init_trace_params(tcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    n_video = tcfg.num_frames * tokens_per_frame(tcfg)
    L = n_video + 16
    ids = rng.integers(0, tcfg.decoder.vocab_size, size=(B, L)).astype(np.int32)
    labels = ids.copy()
    labels[:, : n_video + 4] = -100
    batch = {
        "frames": np.asarray(rng.normal(size=(B, tcfg.num_frames, 56, 56, 3)), np.float32),
        "frame_time_ids": rng.integers(2, 12, (B, tcfg.num_frames, 6)).astype(np.int32),
        "token_ids": ids, "video_pos": np.full((B,), 2, np.int32),
        "attn_mask": np.ones((B, L), bool), "labels": labels,
        "time_labels": np.full((B, L), -100, np.int32),
        "score_labels": np.full((B, L), -100, np.int32),
    }
    tx = optax.sgd(1e-2)
    step = jax.jit(jtrain.make_train_step(tcfg, tx, remat=True, pp_mesh=build_pp_mesh(4),
                                          pp_microbatches=2))
    p2, _, m2 = step(tparams, jax.jit(tx.init)(tparams), jax.tree.map(jnp.asarray, batch))
    want["step/loss"] = float(m2["loss"])
    want["step/params"] = jax.tree.map(np.asarray, p2)

    inputs = {"decoder": _t(params), "x": torch.from_numpy(np.array(x)),
              "mask": torch.from_numpy(np.array(mask)), "pos": torch.from_numpy(np.array(pos)),
              "trace": _t(tparams),
              "batch": {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}}
    return want, run_ranks("pp", inputs, 4, tmp_path_factory.mktemp("pp"))


@pytest.mark.parametrize("stages,micro", PP_CASES)
def test_pp_decoder_forward_matches_sequential(pp, stages, micro):
    want, got = pp
    for out in got:  # every rank returns the whole output
        np.testing.assert_allclose(out[f"fwd/{stages}x{micro}"].numpy(), want["fwd"],
                                   rtol=2e-5, atol=2e-5)


def test_pp_train_step_matches_jax(pp):
    want, got = pp
    jleaves = dict(tree_paths(_t(want["step/params"])))
    for out in got:
        assert np.isclose(out["step/loss"], want["step/loss"], rtol=1e-4)
        leaves = dict(tree_paths(out["step/params"]))
        assert set(leaves) == set(jleaves)
        for path, x in leaves.items():
            np.testing.assert_allclose(x.detach().numpy(), jleaves[path].numpy(),
                                       rtol=5e-4, atol=5e-5,
                                       err_msg=path)
