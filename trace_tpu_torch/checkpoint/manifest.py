"""The key and shape manifest of the released TRACE checkpoints, for the
port's converters: the port's copy of the repository's
``scripts/parity/manifest.py``, run without JAX.

    python -m trace_tpu_torch.checkpoint.manifest --out DIR        # the 7B manifests
    python -m trace_tpu_torch.checkpoint.manifest --selfcheck      # tiny-scale proof
    python -m trace_tpu_torch.checkpoint.manifest --verify CKPT    # diff a checkpoint

The tables follow the layouts the reference's ``load_pretrained_model``
routes (trace/model/builder.py:29-156): the merged directory (decoder,
heads, projector, towers, and the CLIP tower when bundled), a standalone
``mm_projector.bin`` and a standalone CLIP directory. ``--out`` writes the
four ``manifest_*.json`` files, byte for byte the ones committed under
``scripts/parity/``. ``--selfcheck`` synthesizes a state dict of the
manifest's keys and shapes at the tiny config, converts it with the port's
converters (``checkpoint/convert.py``) while it records every key read, and
holds the converted tree leaf for leaf to ``init_trace_params``. ``--verify``
reads a checkpoint directory's tensor shapes (safetensors through a memory
map: no tensor is read) and prints a MISSING, SHAPE or EXTRA line for each
difference from the 7B manifest; it exits 0 only on an exact match.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from trace_tpu_torch.model.config import DecoderConfig, TraceConfig, VisionConfig

# Keys of HF checkpoints that the converters ignore on purpose: CLIP's
# post_layernorm sits after the -2 hidden-state tap the tower reads.
IGNORED_HF_KEYS = {
    "post_layernorm.weight",
    "post_layernorm.bias",
}
# The heads a stage-0 base may lack; the decoder converter fills them with zeros.
OPTIONAL_KEYS = {"sync_head.weight", "time_head.weight", "score_head.weight"}
FILES = (  # layout, bundled CLIP, file name
    ("merged", True, "manifest_trace7b_merged.json"),
    ("merged", False, "manifest_trace7b_merged_novision.json"),
    ("mm_projector", None, "manifest_mm_projector.json"),
    ("clip", None, "manifest_clip_vit_l_336.json"),
)


def decoder_manifest(cfg: DecoderConfig, prefix: str = "model.") -> dict:
    """The Mistral decoder and the TRACE heads (``convert_mistral_decoder``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    NH, NKV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    m = {f"{prefix}embed_tokens.weight": [cfg.vocab_size, D]}
    for i in range(cfg.num_layers):
        lyr = f"{prefix}layers.{i}."
        m.update({
            lyr + "input_layernorm.weight": [D],
            lyr + "post_attention_layernorm.weight": [D],
            lyr + "self_attn.q_proj.weight": [NH * HD, D],
            lyr + "self_attn.k_proj.weight": [NKV * HD, D],
            lyr + "self_attn.v_proj.weight": [NKV * HD, D],
            lyr + "self_attn.o_proj.weight": [D, NH * HD],
            lyr + "mlp.gate_proj.weight": [I, D],
            lyr + "mlp.up_proj.weight": [I, D],
            lyr + "mlp.down_proj.weight": [D, I],
        })
        if cfg.attn_qkv_bias:
            m[lyr + "self_attn.q_proj.bias"] = [NH * HD]
            m[lyr + "self_attn.k_proj.bias"] = [NKV * HD]
            m[lyr + "self_attn.v_proj.bias"] = [NKV * HD]
    m[f"{prefix}norm.weight"] = [D]
    m["lm_head.weight"] = [cfg.vocab_size, D]
    m["sync_head.weight"] = [1, D]
    m["time_head.weight"] = [cfg.time_vocab_size, D]
    m["score_head.weight"] = [cfg.score_vocab_size, D]
    return m


def vision_manifest(cfg: VisionConfig, prefix: str) -> dict:
    """HF CLIPVisionModel (``convert_clip_vision``); ``prefix`` is
    ``model.vision_tower.vision_tower.vision_model.`` when the tower is
    bundled in the merged directory, ``vision_model.`` for a standalone CLIP
    directory."""
    D, I, P = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    n_pos = (cfg.image_size // P) ** 2 + 1
    m = {
        prefix + "embeddings.class_embedding": [D],
        prefix + "embeddings.patch_embedding.weight": [D, 3, P, P],
        prefix + "embeddings.position_embedding.weight": [n_pos, D],
        prefix + "pre_layrnorm.weight": [D],  # HF's spelling; pre_layernorm read too
        prefix + "pre_layrnorm.bias": [D],
    }
    for i in range(cfg.num_layers):
        lyr = prefix + f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            m[lyr + ln + ".weight"] = [D]
            m[lyr + ln + ".bias"] = [D]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[lyr + f"self_attn.{proj}.weight"] = [D, D]
            m[lyr + f"self_attn.{proj}.bias"] = [D]
        m[lyr + "mlp.fc1.weight"] = [I, D]
        m[lyr + "mlp.fc1.bias"] = [I]
        m[lyr + "mlp.fc2.weight"] = [D, I]
        m[lyr + "mlp.fc2.bias"] = [D]
    return m


def connector_manifest(config: TraceConfig, prefix: str = "model.mm_projector.") -> dict:
    """spatial_slot / slot (``convert_spatial_slot``), the projector of the
    three released checkpoints, or a linear one."""
    mm, lm = config.vision.hidden_size, config.decoder.hidden_size
    t = config.mm_projector_type
    if t in ("spatial_slot", "slot"):
        return {
            prefix + "slots": [mm, config.num_slots],
            prefix + "ln_vision.weight": [mm],
            prefix + "ln_vision.bias": [mm],
            prefix + "readout.weight": [lm, mm],  # HF Linear [out, in]
        }
    if t == "linear":
        return {prefix + "weight": [lm, mm], prefix + "bias": [lm]}
    raise NotImplementedError(f"manifest for projector type {t!r} not tabulated (released "
                              "checkpoints all use spatial_slot)")


def towers_manifest(config: TraceConfig, prefix: str = "model.") -> dict:
    D = config.decoder.hidden_size
    return {
        prefix + "time_tower.embed_tokens.weight": [config.decoder.time_vocab_size, D],
        prefix + "score_tower.embed_tokens.weight": [config.decoder.score_vocab_size, D],
        prefix + "sync_tower.embed_tokens.weight": [1, D],
    }


def full_manifest(config: TraceConfig, layout: str = "merged",
                  bundled_vision: bool = True) -> dict:
    """Key -> shape of a layout: ``merged`` (one directory), ``mm_projector``
    (a stage-1 ``mm_projector.bin``) or ``clip`` (a standalone CLIP dir)."""
    if layout == "merged":
        m = {}
        m.update(decoder_manifest(config.decoder))
        m.update(connector_manifest(config))
        m.update(towers_manifest(config))
        if bundled_vision:
            m.update(vision_manifest(config.vision,
                                     "model.vision_tower.vision_tower.vision_model."))
        return m
    if layout == "mm_projector":
        return connector_manifest(config)
    if layout == "clip":
        return vision_manifest(config.vision, "vision_model.")
    raise ValueError(layout)


# The LoRA layout (builder.py:63-92): adapter keys per decoder Linear, at the
# rank the training run chose, and non_lora_trainables.bin with the rest.
LORA_NOTE = {
    "pattern_A": "base_model.model.{linear}.lora_A.weight -> [r, in]",
    "pattern_B": "base_model.model.{linear}.lora_B.weight -> [out, r]",
    "merge": "W' = W + B @ A * (alpha / r)  (checkpoint/loader.py:merge_lora_weights)",
    "non_lora_trainables": "mm_projector/towers/heads keys as in the merged manifest",
}


def released_config() -> TraceConfig:
    """The architecture trace, trace-retrieval and trace-uni share:
    Mistral-7B, CLIP ViT-L/14-336, spatial_slot."""
    return TraceConfig(decoder=DecoderConfig(), vision=VisionConfig(),
                       mm_projector_type="spatial_slot", num_slots=8, num_frames=128,
                       dtype=torch.bfloat16)


def manifest_docs(config: TraceConfig = None) -> dict:
    """File name -> the JSON document of each manifest file."""
    config = config or released_config()
    docs = {}
    for layout, bundled, fname in FILES:
        m = (full_manifest(config, layout) if bundled is None
             else full_manifest(config, layout, bundled_vision=bundled))
        docs[fname] = {
            "checkpoints": ["Yongxin-Guo/trace", "Yongxin-Guo/trace-retrieval",
                            "Yongxin-Guo/trace-uni"],
            "layout": layout + ("" if bundled in (None, True) else "+external-clip"),
            "num_keys": len(m),
            "num_params": sum(math.prod(s) for s in m.values()),
            "notes": {
                "embed_tokens/lm_head": "converter slices [:vocab_size]; "
                                        "larger saved tables are fine",
                "pre_layrnorm": "HF typo; pre_layernorm accepted too",
                "heads": "sync/time/score_head.weight optional (zero-filled)",
                "ignored": sorted(IGNORED_HF_KEYS),
                "lora": LORA_NOTE,
            },
            "keys": m,
        }
    return docs


def write_manifests(out_dir: str) -> None:
    for fname, doc in manifest_docs().items():
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=False)
        print(f"wrote {path}: {doc['num_keys']} keys, {doc['num_params'] / 1e9:.3f}B params")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def selfcheck() -> None:
    """Tiny-scale proof that the manifest is what the port's converters
    read: every key read, none outside it, the converted tree leaf for leaf
    ``init_trace_params``'. Raises AssertionError otherwise."""
    from trace_tpu_torch.checkpoint import convert as C
    from trace_tpu_torch.params import init_trace_params

    config = TraceConfig.tiny()
    manifest = full_manifest(config, "merged", bundled_vision=True)
    accessed: set = set()

    class RecordingSD(dict):
        def __getitem__(self, k):
            accessed.add(k)
            return super().__getitem__(k)

        def get(self, k, default=None):
            return self[k] if k in self else default

    sd = RecordingSD({k: torch.zeros(shape, dtype=torch.float16)
                      for k, shape in manifest.items()})
    f32 = torch.float32
    params = {
        "decoder": C.convert_mistral_decoder(sd, config.decoder, dtype=f32),
        "connector": C.convert_spatial_slot(sd, dtype=f32),
        "towers": C.convert_towers(sd, dtype=f32),
        "vision": C.convert_clip_vision(
            sd, config.vision, prefix="model.vision_tower.vision_tower.vision_model.",
            dtype=f32),
    }
    missing, extra = set(manifest) - accessed, accessed - set(manifest)
    assert not missing, f"manifest keys never read: {sorted(missing)[:8]}"
    assert not extra, f"the converters read keys outside the manifest: {sorted(extra)[:8]}"
    ref = dict(_leaves(init_trace_params(config, torch.Generator().manual_seed(0))))
    got = dict(_leaves(params))
    for path, leaf in got.items():
        assert path in ref, f"converted leaf {path} not in the init tree"
        assert tuple(leaf.shape) == tuple(ref[path].shape), (
            f"{path}: converted {tuple(leaf.shape)} != init {tuple(ref[path].shape)}")
    assert len(got) == len(ref), f"leaf count: converted {len(got)} != init {len(ref)}"
    print(f"selfcheck OK: {len(manifest)} keys read exactly, {len(got)} converted leaves "
          f"match init_trace_params")


def verify(path: str) -> int:
    """Diff a checkpoint directory's tensors against the 7B manifest of its
    ``config.json``: a line for each MISSING key, SHAPE difference and EXTRA
    key; 0 only on an exact match (the heads the converter zero-fills may be
    absent; ``pre_layernorm`` stands for HF's ``pre_layrnorm``; embed_tokens
    and lm_head may hold more rows)."""
    from trace_tpu_torch.checkpoint.convert import (
        load_checkpoint_tensors,
        read_hf_config,
        trace_config_from_hf,
    )

    config = trace_config_from_hf(read_hf_config(path))
    sd = load_checkpoint_tensors(path)  # safetensors: memory-mapped views
    bundled = any(k.startswith("model.vision_tower.") for k in sd)
    manifest = full_manifest(config, "merged", bundled_vision=bundled)
    rc = 0
    for k, shape in sorted(manifest.items()):
        if k not in sd:
            alt = k.replace("pre_layrnorm", "pre_layernorm")
            if alt in sd:
                k = alt
            elif k in OPTIONAL_KEYS:
                print(f"  optional-missing {k} (the converter zero-fills it)")
                continue
            else:
                print(f"MISSING {k} {shape}")
                rc = 1
                continue
        got = list(sd[k].shape)
        wider = (k.endswith("embed_tokens.weight") or k == "lm_head.weight") and (
            got[0] >= shape[0] and got[1:] == shape[1:])
        if got != shape and not wider:
            print(f"SHAPE {k}: checkpoint {got} != expected {shape}")
            rc = 1
    known = set(manifest) | {k.replace("pre_layrnorm", "pre_layernorm") for k in manifest}
    extras = [k for k in sorted(sd)
              if k not in known and not any(k.endswith(s) for s in IGNORED_HF_KEYS)]
    for k in extras:
        print(f"EXTRA {k} {list(sd[k].shape)}")
    rc = rc or int(bool(extras))
    print(f"verify: {len(manifest)} expected, {len(sd)} present, {len(extras)} extra -> "
          f"{'OK' if rc == 0 else 'MISMATCH'}")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selfcheck", action="store_true")
    ap.add_argument("--verify", metavar="CKPT_DIR")
    ap.add_argument("--out", metavar="DIR", default=".",
                    help="where to write the 7B manifests (default: the current directory)")
    args = ap.parse_args(argv)
    if args.selfcheck:
        selfcheck()
        return 0
    if args.verify:
        return verify(args.verify)
    write_manifests(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
