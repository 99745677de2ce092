"""The port's data- and tensor-parallel train step, ``train_loop`` on a mesh
and the multi-process CLI against the JAX package's, on the tiny config:
four ranks of a gloo group on the CPU (``_torch_mp_worker.py train``,
spawned once for the module) against JAX in the test process, with the same
weights and global batch.

* One sft step on a (data 2, model 2) and a (1, 4) mesh over a global batch
  of 4: the loss within 1e-5 and the grad norm within 1e-4 of JAX's step on
  the same global batch (tests/test_multiprocess.py). The port keeps the
  vision tower and the connector whole under a training mesh where JAX's
  rules shard them: the loss and the gradients' norm come out the same.
* Three ``lora`` steps on the same meshes, every projection adapted, B
  nonzero: each step's loss within 1e-5 and grad norm within 1e-4 of JAX's,
  and the updated adapters within 5e-4 / 5e-5 (tests/test_pipeline_parallel.py),
  with the adapters sharded as the JAX rules place them (on r at model 2;
  whole on r at model 4 beside shares of their other dimension).
* ``train_loop`` on a mesh writes a checkpoint file a rank and resumes from
  it to the same step and params.
* The CLI, two processes, one step each with ``--num-processes 2`` and with
  ``--pp-stages 2``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mp_train_worker import build_sample
from _torch_mp_worker import (
    LORA,
    LORA_RECIPE,
    LORA_STEPS,
    LORA_TARGETS,
    REPO,
    free_port,
    run_ranks,
)
from trace_tpu.data.dataset import collate_batch
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.model.lora import add_lora_params
from trace_tpu.model.trace_model import init_trace_params
from trace_tpu.tokenizers.text import ByteTokenizer
from trace_tpu.train import train as jtrain
from trace_tpu_torch.params import from_jax_params


def _t(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _jax_lora_steps(cfg, params, batch):
    """JAX's LORA_STEPS lora steps on the global batch, every projection
    adapted and B drawn nonzero (so the adapters move the forward and A
    takes a gradient); the tree they start from."""
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **LORA))
    dec = add_lora_params(params["decoder"], cfg.decoder, jax.random.PRNGKey(3),
                          targets=LORA_TARGETS)
    rng = np.random.default_rng(4)
    dec["layers"] = {k: (jnp.asarray(rng.normal(0.0, 0.05, v.shape), v.dtype)
                         if k.endswith("_lora_b") else v) for k, v in dec["layers"].items()}
    start = {**params, "decoder": dec}
    tx = jtrain.build_optimizer(start, jtrain.TrainRecipe(**LORA_RECIPE))
    step = jax.jit(jtrain.make_train_step(cfg, tx, freeze_stage="lora", use_flash=False))
    p, state, losses, norms = start, jax.jit(tx.init)(start), [], []
    for _ in range(LORA_STEPS):
        p, state, m = step(p, state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    adapters = {f"decoder/layers/{k}": np.asarray(v)
                for k, v in p["decoder"]["layers"].items() if "_lora_" in k}
    return {"losses": losses, "grad_norms": norms, "adapters": adapters}, start


@pytest.fixture(scope="module")
def dptp(tmp_path_factory):
    """JAX's single-process step of tests/_mp_train_worker.py on the same
    global batch, and the port's ranks."""
    cfg = JTraceConfig.tiny()
    tok = ByteTokenizer()
    samples = [build_sample(cfg, tok, i) for i in range(4)]
    batch = collate_batch(samples)
    params = init_trace_params(cfg, jax.random.PRNGKey(0))
    recipe = jtrain.TrainRecipe.stage2(total_steps=2)
    tx = jtrain.build_optimizer(params, recipe)
    step = jax.jit(jtrain.make_train_step(cfg, tx, freeze_stage=recipe.stage, use_flash=False))
    _, _, m = step(params, jax.jit(tx.init)(params), jax.tree.map(jnp.asarray, batch))
    want = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    want["lora"], lora_params = _jax_lora_steps(cfg, params, batch)
    tmp = tmp_path_factory.mktemp("train")
    inputs = {"params": _t(params), "lora_params": _t(lora_params), "tmp": str(tmp),
              "batch": {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
              "samples": [{k: np.array(v) for k, v in s.items()} for s in samples]}
    return want, run_ranks("train", inputs, 4, tmp)


@pytest.mark.parametrize("mesh", ["m2", "m4"])
def test_dp_tp_train_step_matches_jax(dptp, mesh):
    want, got = dptp
    for out in got:
        assert abs(out[f"{mesh}/loss"] - want["loss"]) < 1e-5, (out[f"{mesh}/loss"], want)
        assert abs(out[f"{mesh}/grad_norm"] - want["grad_norm"]) < 1e-4, (
            out[f"{mesh}/grad_norm"], want)


@pytest.mark.parametrize("mesh", ["m2", "m4"])
def test_dp_tp_lora_steps_match_jax(dptp, mesh):
    want, got = dptp
    want = want["lora"]
    assert want["losses"][-1] != want["losses"][0]  # the adapters moved the loss
    for out in got:
        np.testing.assert_allclose(out[f"{mesh}/lora/losses"], want["losses"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out[f"{mesh}/lora/grad_norms"], want["grad_norms"], rtol=0,
                                   atol=1e-4)
        adapters = out[f"{mesh}/lora/adapters"]
        assert set(adapters) == set(want["adapters"])
        for path, w in want["adapters"].items():
            np.testing.assert_allclose(adapters[path].numpy(), w, rtol=5e-4, atol=5e-5,
                                       err_msg=path)


def test_train_loop_on_a_mesh_checkpoints_and_resumes(dptp):
    _, got = dptp
    for out in got:
        assert out["loop/files"] == [f"state-{r}-of-4.pt" for r in range(4)]
        assert out["loop/resumed_count"] == 2 and out["loop/resumed_equal"]
        assert np.isfinite(out["loop/loss"])
    # the decoder's sharded leaves: each rank holds its half (model 2)
    shapes = got[0]["loop/shapes"]
    assert shapes["decoder/layers/wq"] == (2, 64, 2, 16)
    assert shapes["decoder/lm_head"] == (64, 192)
    assert shapes["vision/layers/wq"] == (3, 32, 32)  # whole: see runtime/mesh.py


@pytest.mark.parametrize("flags", [[], ["--pp-stages", "2"]], ids=["mesh", "pipeline"])
def test_cli_trains_over_two_processes(tmp_path, flags):
    records = [{"conversations": [{"from": "human", "value": f"What is {i} plus {i}?"},
                                  {"from": "gpt", "value": f"It is {2 * i}."}]}
               for i in range(4)]
    data = tmp_path / "anno.json"
    data.write_text(json.dumps(records))
    out = tmp_path / "run"
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "trace_tpu_torch.train.cli", "--stage", "sft",
         "--data-path", str(data), "--output-dir", str(out), "--num-frames", "4",
         "--max-len", "700", "--device", "cpu", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(r)] + flags,
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        outs.append(stdout)
    assert "final metrics" in outs[0] and "final metrics" not in outs[1]
    assert ("pipeline mesh" if flags else "mesh: {'data': 1, 'model': 2}") in outs[0]
    assert sorted(os.listdir(out / "checkpoints" / "checkpoint-2")) == [
        "state-0-of-2.pt", "state-1-of-2.pt"]
