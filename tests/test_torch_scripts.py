"""The port's twins of the launch scripts (``*_torch.sh``, ``*_torch.py``)
against the JAX package's scripts beside them.

- Each shell twin parses (``bash -n``) and runs the port's module with the
  JAX script's environment variables and flags, line for line.
- Every Python twin answers ``--help`` and takes ``--device``.
- The inference, serving and example twins with ``--device cpu`` on a tiny
  merged checkpoint written here print (or write) the JSON of the JAX
  scripts on the same checkpoint. Both packages' ``model_init`` load it in
  fp32 here (the scripts' default dtype is bf16, whose host arithmetic
  differs between XLA and PyTorch), the JAX side's serving kernels
  interpreted as tests/test_torch_families.py runs them.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import (
    jax_config,
    tiny_vision,  # noqa: F401  (a fixture)
    write_hf_tokenizer,
    write_merged_checkpoint,
)
from test_torch_families import jax_serving_kernels_interpreted  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SHELL_TWINS = {"scripts/train/pretrain-128_torch.sh": "scripts/train/pretrain-128.sh",
               "scripts/train/sft-128_torch.sh": "scripts/train/sft-128.sh",
               "scripts/train/sft-youcook2_torch.sh": "scripts/train/sft-youcook2.sh",
               "scripts/eval/eval_torch.sh": "scripts/eval/eval.sh"}
PY_TWINS = {"scripts/inference/inference_torch.py": "scripts/inference/inference.py",
            "scripts/inference/serve_batch_torch.py": "scripts/inference/serve_batch.py",
            "examples/inference_torch.py": "examples/inference.py"}
ASK = "Localize a series of activity events in the video ."


def _commands(path: Path) -> list:
    """The script's lines that are not comments."""
    return [line for line in path.read_text().splitlines() if not line.startswith("#")]


@pytest.mark.parametrize("twin", sorted(SHELL_TWINS))
def test_shell_twin_runs_the_port_with_the_jax_flags(twin):
    subprocess.run(["bash", "-n", str(ROOT / twin)], check=True)
    want = [line.replace("python -m trace_tpu.", "python -m trace_tpu_torch.")
            for line in _commands(ROOT / SHELL_TWINS[twin])]
    got = _commands(ROOT / twin)
    assert got == want
    assert any("python -m trace_tpu_torch." in line for line in got)
    assert not any("python -m trace_tpu." in line for line in got)


@pytest.mark.parametrize("twin", sorted(PY_TWINS))
def test_python_twin_answers_help(twin):
    out = subprocess.run([sys.executable, str(ROOT / twin), "--help"], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert "--device" in out


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny merged checkpoint (2 decoder layers) with a word-level
    tokenizer, and two 10-frame ``.npy`` videos in a folder of their own."""
    cfg = jax_config(decoder=dict(num_layers=2, head_dim=128, hidden_size=256,
                                  intermediate_size=256, num_heads=2, num_kv_heads=2))
    path = tmp_path_factory.mktemp("ckpt")
    write_merged_checkpoint(path, cfg, seed=51, shards=2)
    write_hf_tokenizer(path, cfg.decoder.vocab_size)
    videos = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(52)
    for i in range(2):
        np.save(videos / f"v{i}.npy", rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8))
    return path, videos, cfg.num_frames


@pytest.fixture
def fp32_model_init(monkeypatch, tiny_vision, jax_serving_kernels_interpreted):
    """Both packages' ``model_init`` (where the scripts import it from) load
    in fp32; the port's records the devices it was asked for."""
    import trace_tpu
    import trace_tpu.runtime.pipeline as jpl
    import trace_tpu_torch
    import trace_tpu_torch.runtime.pipeline as tpl

    jreal, treal, devices = jpl.model_init, tpl.model_init, []

    def port(*a, **k):
        devices.append(k.get("device"))
        return treal(*a, **{**k, "dtype": torch.float32})

    for mod in (trace_tpu, jpl):
        monkeypatch.setattr(mod, "model_init", lambda *a, **k: jreal(*a, **{**k, "dtype": jnp.float32}))
    for mod in (trace_tpu_torch, tpl):
        monkeypatch.setattr(mod, "model_init", port)
    # the JAX inference script points JAX's compilation cache at ./.jax_cache
    # for the rest of the process; keep that out of the tests that follow
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None if name ==
                        "jax_compilation_cache_dir" else real_update(name, value))
    return devices


def test_inference_twin_prints_the_jax_scripts_json(ckpt, fp32_model_init, monkeypatch, capsys):
    path, videos, frames = ckpt
    video = str(videos / "v0.npy")
    monkeypatch.setenv("MODEL_PATH", str(path))
    monkeypatch.setenv("FRAMES", str(frames))
    monkeypatch.setenv("MAX_NEW_TOKENS", "16")
    monkeypatch.setattr(sys, "argv", ["inference.py", video, ASK])
    _load("scripts/inference/inference.py", "jax_inference_script").main()
    want = capsys.readouterr().out
    got = _load("scripts/inference/inference_torch.py", "inference_torch").main(
        [video, ASK, "--device", "cpu"])
    assert capsys.readouterr().out == want and got == json.loads(want)
    assert fp32_model_init == ["cpu"]


def test_serve_batch_twin_writes_the_jax_scripts_jsonl(ckpt, fp32_model_init, monkeypatch,
                                                      tmp_path, capsys):
    path, videos, frames = ckpt
    flags = ["--model-path", str(path), "--videos", str(videos), "--batch", "2",
             "--frames", str(frames), "--max-new-tokens", "8", "--quant", "bf16"]
    monkeypatch.setattr(sys, "argv", ["serve_batch.py", "--out", str(tmp_path / "j.jsonl")]
                        + flags)
    _load("scripts/inference/serve_batch.py", "jax_serve_batch_script").main()
    result = _load("scripts/inference/serve_batch_torch.py", "serve_batch_torch").main(
        ["--out", str(tmp_path / "t.jsonl"), "--device", "cpu"] + flags)
    got = (tmp_path / "t.jsonl").read_text().splitlines()
    assert got == (tmp_path / "j.jsonl").read_text().splitlines()
    assert len(got) == 2 and result["ok"] == 2
    assert fp32_model_init == ["cpu"]
    assert capsys.readouterr().out.splitlines()[-1].startswith("2/2 videos ->")


@pytest.mark.parametrize("retrieval", [False, True])
def test_example_twin_prints_the_jax_examples_json(ckpt, fp32_model_init, monkeypatch, capsys,
                                                   retrieval):
    """``--retrieval``: the corpus path with the timestamp constraint on both
    sides."""
    path, videos, frames = ckpt
    flags = ["--model-path", str(path), "--video", str(videos / "v1.npy"), "--question", ASK,
             "--num-frames", str(frames), "--max-new-tokens", "16"] + ["--retrieval"] * retrieval
    monkeypatch.setattr(sys, "argv", ["inference.py"] + flags)
    _load("examples/inference.py", "jax_example").main()
    want = capsys.readouterr().out
    got = _load("examples/inference_torch.py", "example_torch").main(flags + ["--device", "cpu"])
    assert capsys.readouterr().out == want and got == json.loads(want)
    assert fp32_model_init == ["cpu"]
