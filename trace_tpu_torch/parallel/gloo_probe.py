"""Which collectives a gloo process group takes on CUDA tensors, and what
they cost: two ranks on one card (NCCL refuses two ranks on one device).

    python -m trace_tpu_torch.parallel.gloo_probe

Each rank puts its tensors on ``cuda:0``. Each collective runs in a pair
of ranks of its own (a gloo transport fed a device pointer aborts the
process); it prints "ok", the error's first line, or how the ranks died;
then the median time of ``all_reduce``
(SUM) and ``broadcast`` at the sizes the parallel paths move (a decode
step's [2, 1, 4096] fp32 partial sum, a prefill layer's [2, 2048, 4096]
in bf16 and fp32), host clock around a synchronized call, 5 warm-up calls
and 20 timed. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


OPS = ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather",
       "all_gather_into_tensor", "reduce_scatter", "reduce", "send_recv")


def _op(name: str, x, rank: int, world: int):
    import torch
    import torch.distributed as dist

    if name == "all_reduce_sum":
        y = x.clone()
        dist.all_reduce(y)
        assert bool((y == world * (world + 1) / 2).all()), "wrong sum"
    elif name == "all_reduce_max":
        dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX)
    elif name == "broadcast":
        dist.broadcast(x.clone(), src=0)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(x.new_empty(world * x.numel()), x)
    elif name == "reduce_scatter":
        dist.reduce_scatter(torch.empty_like(x), [x.clone() for _ in range(world)])
    elif name == "reduce":
        dist.reduce(x.clone(), dst=0)
    elif name == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(torch.empty_like(x), 0)
    torch.cuda.synchronize()


def _rank(rank: int, world: int, port: int, what: str, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    res = {}
    if what != "times":
        x = torch.full((1024,), float(rank + 1), device=dev)
        try:
            _op(what, x, rank, world)
            res[what] = "ok"
        except Exception as e:  # noqa: BLE001 - the answer is which ones raise
            res[what] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    else:
        for name, shape, dtype in (("step_fp32_2x1x4096", (2, 1, 4096), torch.float32),
                                   ("layer_bf16_2x2048x4096", (2, 2048, 4096), torch.bfloat16),
                                   ("layer_fp32_2x2048x4096", (2, 2048, 4096), torch.float32)):
            t = torch.ones(shape, dtype=dtype, device=dev)
            for op in ("all_reduce", "broadcast"):
                fn = (lambda: dist.all_reduce(t)) if op == "all_reduce" else (
                    lambda: dist.broadcast(t, src=0))
                ms = []
                for i in range(25):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if i >= 5:
                        ms.append(1e3 * (time.perf_counter() - t0))
                res[f"{op}_{name}_ms"] = statistics.median(ms)
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def _pair(what: str, timeout: float = 60.0) -> dict:
    """One collective (or the timings) in a fresh pair of ranks: a gloo
    error on a CUDA pointer can abort the process, which no try catches."""
    import torch.multiprocessing as mp

    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"gloo_probe_{os.getpid()}.json")
    ctx = mp.start_processes(_rank, args=(2, _free_port(), what, out), nprocs=2,
                             join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > timeout:
                for p in ctx.processes:
                    p.kill()
                return {what: f"hung past {timeout:.0f} s"}
    except Exception as e:  # noqa: BLE001 - a rank that died says the same
        return {what: f"rank died: {str(e).splitlines()[0][:160]}"}
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    res = {"torch": torch.__version__, "cuda": torch.version.cuda}
    for what in OPS + ("times",):
        res.update(_pair(what))
        print(json.dumps({k: v for k, v in res.items() if k in (what,) or k.endswith("_ms")}),
              flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    print(json.dumps(res, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
