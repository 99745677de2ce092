"""Rank worker of the port's multi-process CPU tests (test_torch_parallel.py,
test_torch_pp.py): one process of a gloo group, one CPU "device" a rank.

    python tests/_torch_mp_worker.py TASK --rank R --world N --port P \\
        --inp INPUTS.pt --out DIR

It joins the group through ``trace_tpu_torch.runtime.distributed.initialize``,
loads the inputs the test wrote (tensors from the JAX package's trees,
converted in the test process), runs TASK and writes ``DIR/rank<R>.pt``.
It imports neither JAX nor the JAX package: the test compares.

``run_ranks`` (imported by the tests) spawns a group and collects the
results.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(task: str, inputs: dict, world: int, tmp_path, timeout: float = 300.0) -> list:
    """Spawn ``world`` ranks of ``task`` on ``inputs``; their results, in
    rank order. Raises with a rank's stderr if one fails."""
    import torch

    inp = os.path.join(str(tmp_path), f"{task}_inputs.pt")
    torch.save(inputs, inp)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, "--rank", str(r), "--world",
         str(world), "--port", str(port), "--inp", inp, "--out", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{task}: rank {r} did not finish in {timeout} s")
        if p.returncode:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    if errors:
        raise AssertionError(f"{task}:\n" + "\n".join(errors))
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# tasks: (inputs) -> a dict of results, run on every rank
# ---------------------------------------------------------------------------

def _serve(inp: dict) -> dict:
    """generate_sharded (fp32, int8; greedy, constrained; int4p refused) on a
    (2, 2) and a (1, 4) mesh, encode_prefix_sharded, expert-parallel
    moe_mlp in both forms."""
    import torch

    from trace_tpu_torch.model.config import DecoderConfig, MoEConfig, TraceConfig
    from trace_tpu_torch.model.moe import moe_mlp
    from trace_tpu_torch.runtime.generate import generate_sharded
    from trace_tpu_torch.runtime.mesh import build_mesh, shard_params_for_inference
    from trace_tpu_torch.runtime.pipeline import encode_prefix_sharded

    cfg = DecoderConfig.tiny()
    int8_cfg = dataclasses.replace(cfg, act_quant=True, kv_cache_dtype="int8")
    out = {}
    meshes = {"m2": build_mesh(4, model_axis=2, device="cpu"),
              "m4": build_mesh(4, model_axis=4, device="cpu")}
    greedy = dict(max_new_tokens=16, initial_head=1, eos_id=-5)
    constrained = dict(max_new_tokens=12, initial_head=1, eos_id=-5, constrain_time=True,
                       frame_time_ids=inp["fids"])
    for mname, mesh in meshes.items():
        for tree, c in (("fp32", cfg), ("int8", int8_cfg)):
            params = shard_params_for_inference(inp[tree], mesh)
            for kind, kw in (("greedy", greedy), ("constrained", constrained)):
                g = generate_sharded(params, c, inp["prefix"], inp["mask"], inp["combined"],
                                     mesh=mesh, **kw)
                out[f"{mname}/{tree}/{kind}"] = (g.tokens, g.num_generated)
        try:
            generate_sharded(shard_params_for_inference(inp["int4p"], mesh), cfg,
                             inp["prefix"], inp["mask"], inp["combined"], mesh=mesh,
                             **greedy)
            out[f"{mname}/int4p"] = None
        except ValueError as e:
            out[f"{mname}/int4p"] = str(e)
        e = inp["encode"]
        out[f"{mname}/encode"] = encode_prefix_sharded(
            e["params"], TraceConfig.tiny(), e["token_ids"], e["video_pos"], e["frames"],
            e["fids"], inp["combined"], mesh)
    # expert parallel: a rank's experts of one layer, on the (1, 4) mesh
    mesh, m = meshes["m4"], inp["moe"]
    r, n = mesh.coord("model"), m["lp"]["w_gate"].shape[0] // 4
    local = {k: (v if k == "router" else v[r * n:(r + 1) * n]) for k, v in m["lp"].items()}
    for form in ("dense", "sparse"):
        mcfg = dataclasses.replace(MoEConfig.tiny_moe(), moe_impl=form)
        out[f"moe/{form}"] = moe_mlp(m["x"], local, mcfg, group=mesh.group("model"))
    out["coords"] = {k: (v.coords, v.shape) for k, v in meshes.items()}
    return out


# the tensor-parallel LoRA case: a rank that divides the 'model' axis of 2
# but not 4, so the adapters shard on r at model 2 and stay whole there at 4,
# beside shares of their other dimension (the JAX rules' mixed placements);
# steps past the first, whose warmup learning rate is 0
LORA = dict(lora_r=6, lora_alpha=12.0)
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_RECIPE = dict(stage="lora", learning_rate=1e-3, total_steps=10)
LORA_STEPS = 3


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


class SGD:
    """x -= lr g on every leaf that takes a gradient (optax.sgd): the
    optimizer of the JAX package's pipeline-parallel step test."""

    def __init__(self, params: dict, lr: float):
        from trace_tpu_torch.train.train import tree_paths

        self.lr = lr
        self.labels = {p: "base" for p, _ in tree_paths(params)}

    def update(self, params, state, grads):
        import torch

        from trace_tpu_torch.train.train import tree_paths

        with torch.no_grad():
            for path, x in tree_paths(params):
                if path in grads:
                    x.sub_(grads[path].to(x.dtype), alpha=self.lr)


def _pp(inp: dict) -> dict:
    """pp_decoder_forward at (stages, microbatches) (4, 2), (2, 4), (1, 2)
    over the 4 ranks, and one pipelined SGD train step (4 stages, 2
    microbatches, remat)."""
    import torch

    from trace_tpu_torch.model.config import DecoderConfig, TraceConfig, VisionConfig
    from trace_tpu_torch.parallel.pipeline import build_pp_mesh, pp_decoder_forward
    from trace_tpu_torch.train.train import make_train_step

    cfg = dataclasses.replace(DecoderConfig.tiny(), num_layers=4)
    out = {}
    for stages, micro in ((4, 2), (2, 4), (1, 2)):
        mesh = build_pp_mesh(stages, 4, device="cpu")
        out[f"fwd/{stages}x{micro}"] = pp_decoder_forward(
            inp["decoder"], cfg, inp["x"], inp["mask"], inp["pos"], mesh=mesh,
            num_microbatches=micro)
    tcfg = TraceConfig(decoder=cfg, vision=VisionConfig.tiny(), num_slots=4, num_frames=4,
                       dtype=torch.float32)
    params = _clone(inp["trace"])
    mesh = build_pp_mesh(4, device="cpu")
    step = make_train_step(tcfg, SGD(params, 1e-2), remat=True, pp_mesh=mesh,
                           pp_microbatches=2)
    params, _, metrics = step(params, {}, dict(inp["batch"]))
    out["step/loss"] = float(metrics["loss"])
    out["step/params"] = params
    return out


def _train(inp: dict) -> dict:
    """One sft step of the tiny model over a global batch of 4 on a (2, 2)
    and a (1, 4) mesh (each rank its 'data' rows), and LORA_STEPS lora steps
    on both meshes (the adapters' losses, grad norms and updated adapters,
    made whole); then ``train_loop`` on the (2, 2) mesh: two steps with
    per-rank checkpoints, and a resume."""
    import torch

    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.parallel.collectives import gather
    from trace_tpu_torch.runtime.distributed import process_order_shard
    from trace_tpu_torch.runtime.mesh import (
        build_mesh,
        param_spec,
        shard_params,
        sharded_paths,
    )
    from trace_tpu_torch.train.train import (
        TrainRecipe,
        build_optimizer,
        make_train_step,
        train_loop,
        tree_paths,
    )

    cfg = TraceConfig.tiny()
    lora_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **LORA))
    out = {}
    for name, model in (("m2", 2), ("m4", 4)):
        mesh = build_mesh(4, model_axis=model, device="cpu")
        rows = process_order_shard(list(range(4)), 4, index=mesh.coord("data"),
                                   count=mesh.shape["data"])
        batch = {k: v[rows] for k, v in inp["batch"].items()}
        for stage, c, tree, recipe, steps in (
                ("sft", cfg, inp["params"], TrainRecipe.stage2(total_steps=2), 1),
                ("lora", lora_cfg, inp["lora_params"], TrainRecipe(**LORA_RECIPE), LORA_STEPS)):
            params = shard_params(_clone(tree), mesh)
            tx = build_optimizer(params, recipe, sharded=sharded_paths(tree, mesh),
                                 group=mesh.group("model"))
            step = make_train_step(c, tx, freeze_stage=recipe.stage, mesh=mesh)
            state, losses, norms = tx.init(params), [], []
            for _ in range(steps):
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            if stage == "sft":
                out[f"{name}/loss"], out[f"{name}/grad_norm"] = losses[0], norms[0]
                continue
            out[f"{name}/lora/losses"], out[f"{name}/lora/grad_norms"] = losses, norms
            whole = dict(tree_paths(tree))
            adapters = {}
            for path, x in tree_paths(params):
                if "_lora_" not in path:
                    continue
                x = x.detach()
                for dim, axis in enumerate(param_spec(path, whole[path], mesh)):
                    if axis is not None and mesh.shape[axis] > 1:
                        x = gather(x, dim, mesh.group(axis))
                adapters[path] = x
            out[f"{name}/lora/adapters"] = adapters

    class Samples:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return inp["samples"][i]

    mesh = build_mesh(4, model_axis=2, device="cpu")
    recipe = TrainRecipe(stage="pretrain", learning_rate=1e-3, total_steps=2)
    ck = os.path.join(inp["tmp"], "ck")
    trained, state, m = train_loop(_clone(inp["params"]), cfg, Samples(), recipe, batch_size=2,
                                   mesh=mesh, log_every=0, checkpoint_dir=ck, save_every=1)
    out["loop/loss"] = float(m["loss"])
    torch.distributed.barrier()  # every rank's file is written
    out["loop/files"] = sorted(os.listdir(os.path.join(ck, "checkpoint-2")))
    resumed, state2, _ = train_loop(_clone(inp["params"]), cfg, Samples(), recipe, batch_size=2,
                                    mesh=mesh, log_every=0, checkpoint_dir=ck)
    out["loop/resumed_count"] = state2["count"]
    out["loop/resumed_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_paths(trained), tree_paths(resumed)))
    out["loop/shapes"] = {p: tuple(x.shape) for p, x in tree_paths(trained)}
    return out


TASKS = {"serve": _serve, "pp": _pp, "train": _train}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("task", choices=sorted(TASKS))
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import torch

    torch.set_num_threads(1)
    from trace_tpu_torch.runtime.distributed import initialize

    initialize(f"localhost:{args.port}", args.world, args.rank, backend="gloo")
    inp = torch.load(args.inp, weights_only=False)
    with torch.no_grad() if args.task == "serve" else torch.enable_grad():
        out = TASKS[args.task](inp)
    if any(m in sys.modules for m in ("jax", "trace_tpu")):
        raise RuntimeError("a rank imported JAX or the JAX package")
    torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
