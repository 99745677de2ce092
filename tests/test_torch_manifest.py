"""The port's checkpoint manifest (trace_tpu_torch/checkpoint/manifest.py)
and runbook (scripts/parity/run_all_torch.sh), without JAX on the port's
side.

* ``selfcheck``: a state dict of the manifest's keys at the tiny config,
  converted by the port's converters, reads every key and no other and
  gives ``init_trace_params``' tree leaf for leaf.
* ``--out`` writes the four ``manifest_*.json`` committed under
  scripts/parity/ byte for byte (the 7B merged one: 690 keys, 7.4-7.7e9
  parameters), and every layout's table equals the JAX script's
  (scripts/parity/manifest.py) at the released and the tiny config.
* ``verify`` on a tiny checkpoint written here (the merged layout without
  the CLIP tower, shapes from its config.json): 0 on the whole one, 1 with
  a MISSING, SHAPE or EXTRA line on a broken copy.
"""

import importlib.util
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from trace_tpu_torch.checkpoint import manifest as tman

REPO = Path(__file__).resolve().parents[1]
PARITY = REPO / "scripts" / "parity"
TINY_HF = {"model_type": "mistral", "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": 384, "num_slots": 4, "num_frames": 4}


def _jax_manifest_module():
    spec = importlib.util.spec_from_file_location("parity_manifest", PARITY / "manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_selfcheck(capsys):
    tman.selfcheck()
    assert "selfcheck OK" in capsys.readouterr().out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("manifests")
    assert tman.main(["--out", str(out)]) == 0
    return out


@pytest.mark.parametrize("fname", [f for _, _, f in tman.FILES])
def test_out_equals_the_committed_json(written, fname):
    assert (written / fname).read_bytes() == (PARITY / fname).read_bytes()


def test_7b_totals(written):
    doc = json.loads((written / "manifest_trace7b_merged.json").read_text())
    assert doc["num_keys"] == 690
    assert 7.4e9 < doc["num_params"] < 7.7e9
    assert "model.layers.31.mlp.down_proj.weight" in doc["keys"]
    assert doc["keys"]["model.mm_projector.readout.weight"] == [4096, 1024]


@pytest.mark.parametrize("layout,bundled", [("merged", True), ("merged", False),
                                            ("mm_projector", None), ("clip", None)])
@pytest.mark.parametrize("scale", ["released", "tiny"])
def test_tables_equal_the_jax_scripts(layout, bundled, scale):
    from trace_tpu.model.config import TraceConfig as JTraceConfig
    from trace_tpu_torch.model.config import TraceConfig

    jm = _jax_manifest_module()
    jcfg = jm._released_config() if scale == "released" else JTraceConfig.tiny()
    cfg = tman.released_config() if scale == "released" else TraceConfig.tiny()
    kw = {} if bundled is None else {"bundled_vision": bundled}
    assert tman.full_manifest(cfg, layout, **kw) == jm.full_manifest(jcfg, layout, **kw)


def _write_safetensors(path: Path, tensors: dict) -> None:
    header, blobs, off = {}, [], 0
    for k, t in tensors.items():
        b = t.numpy().tobytes()
        header[k] = {"dtype": "F16", "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def _tiny_checkpoint(path: Path, edit=None) -> None:
    """The tiny merged checkpoint (no CLIP tower) in two safetensors shards;
    ``edit(tensors)`` breaks it first."""
    from trace_tpu_torch.checkpoint.convert import trace_config_from_hf

    path.mkdir()
    (path / "config.json").write_text(json.dumps(TINY_HF))
    keys = tman.full_manifest(trace_config_from_hf(TINY_HF), "merged", bundled_vision=False)
    tensors = {k: torch.zeros(shape, dtype=torch.float16) for k, shape in keys.items()}
    if edit:
        edit(tensors)
    names = sorted(tensors)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        _write_safetensors(path / f"model-0000{i + 1}-of-00002.safetensors",
                           {k: tensors[k] for k in part})


def test_verify_passes_a_whole_checkpoint(tmp_path, capsys):
    _tiny_checkpoint(tmp_path / "ckpt")
    assert tman.verify(str(tmp_path / "ckpt")) == 0
    out = capsys.readouterr().out
    assert "-> OK" in out and "MISSING" not in out and "EXTRA" not in out


def _drop(t):
    del t["model.layers.1.mlp.down_proj.weight"]


def _reshape(t):
    t["model.layers.0.self_attn.k_proj.weight"] = torch.zeros((16, 64), dtype=torch.float16)


def _extra(t):
    t["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.zeros((8,), dtype=torch.float16)


def _no_heads(t):
    for k in tman.OPTIONAL_KEYS:
        del t[k]


@pytest.mark.parametrize("edit,line,rc", [
    (_drop, "MISSING model.layers.1.mlp.down_proj.weight", 1),
    (_reshape, "SHAPE model.layers.0.self_attn.k_proj.weight", 1),
    (_extra, "EXTRA model.layers.0.self_attn.rotary_emb.inv_freq", 1),
    (_no_heads, "optional-missing sync_head.weight", 0),
])
def test_verify_reports_a_broken_checkpoint(tmp_path, capsys, edit, line, rc):
    _tiny_checkpoint(tmp_path / "ckpt", edit)
    assert tman.verify(str(tmp_path / "ckpt")) == rc
    assert line in capsys.readouterr().out


def test_verify_cli_on_a_missing_shard(tmp_path):
    """The module's command line, as stage 0 of the runbook runs it: a
    directory of links to the shards but the second gives a nonzero exit
    and MISSING lines."""
    _tiny_checkpoint(tmp_path / "ckpt")
    cut = tmp_path / "cut"
    cut.mkdir()
    for f in ("config.json", "model-00001-of-00002.safetensors"):
        os.symlink(tmp_path / "ckpt" / f, cut / f)
    run = lambda d: subprocess.run(
        [sys.executable, "-m", "trace_tpu_torch.checkpoint.manifest", "--verify", str(d)],
        capture_output=True, text=True, cwd=REPO)
    whole, broken = run(tmp_path / "ckpt"), run(cut)
    assert whole.returncode == 0, whole.stdout + whole.stderr
    assert broken.returncode != 0 and "MISSING " in broken.stdout


def test_runbook_script_runs_the_port_alone():
    """run_all_torch.sh has run_all.sh's five stages and calls no JAX module."""
    text = (PARITY / "run_all_torch.sh").read_text()
    for stage in range(5):
        assert f"=== stage {stage}:" in text
    assert "jax" not in text.lower().replace("without jax", "")
    assert "trace_tpu." not in text and "trace_tpu/" not in text
    assert "python -m trace_tpu_torch.checkpoint.manifest --verify" in text
    assert "--noconftest" in text and "tests/test_torch_real_checkpoint.py" in text
