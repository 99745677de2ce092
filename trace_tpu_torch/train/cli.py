"""Training CLI (trace_tpu/train/cli.py): the same flags.

Stage recipes:
  --stage pretrain   freeze LM backbone; tune connector (projector lr 1e-3)
                     + time/score/sync towers + aux heads
  --stage sft        unfreeze backbone; lr 5e-6; rand frame sampling
  --stage lora       freeze the base weights; train rank --lora-r adapters on
                     the seven decoder projections; lr 1e-4

Example:
  python -m trace_tpu_torch.train.cli --stage pretrain \\
      --data-path anno.json --output-dir runs/stage1 \\
      --num-frames 128 --batch-size 2 --epochs 1

--init-checkpoint starts from a TRACE checkpoint (``checkpoint.loader
.load_pretrained``), --base-llm assembles stage 0 from a base LLM and the
CLIP dir of --vision-path (``checkpoint.convert.build_from_base_models``,
resuming the connector from --pretrain-mm-adapter); both read the
tokenizer saved beside the weights. Without either it trains the tiny random
model, as the JAX package's CLI does.

More than one process: every process runs the CLI with the same
--coordinator (host:port of rank 0's rendezvous) and --num-processes, and
its own --process-id (or the torchrun variables, ``runtime/distributed.py
initialize``); a rank takes the CUDA card of its local index, or --device.
--pp-stages S pipelines the decoder over S stages (a rank a stage, S must
divide the processes; ``parallel/pipeline.py``); otherwise the processes
form a ('data', 'model') mesh (``runtime/mesh.py build_mesh`` over
--mesh-devices, 0 = all) for data- and tensor-parallel training.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="TRACE training (PyTorch/CUDA port)")
    ap.add_argument("--stage", choices=["pretrain", "sft", "lora"], required=True)
    ap.add_argument("--data-path", required=True, help="annotation JSON")
    ap.add_argument("--data-folder", default="")
    ap.add_argument("--base-llm", default=None,
                    help="base HF LLM dir for stage-0 assembly")
    ap.add_argument("--pretrain-mm-adapter", default=None,
                    help="stage-1 mm_projector.bin to resume the connector from "
                         "(with --base-llm)")
    ap.add_argument("--init-checkpoint", default=None,
                    help="HF checkpoint dir to start from")
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--num-frames", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=2, help="per-step global batch")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--projector-lr", type=float, default=None)
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--sample-scheme", default=None,
                    help="uniform (stage1) / rand (stage2 default)")
    ap.add_argument("--save-steps", type=int, default=2000)
    ap.add_argument("--mesh-devices", type=int, default=0, help="0 = all")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--lora-r", type=int, default=128,
                    help="LoRA rank for --stage lora (reference default)")
    ap.add_argument("--lora-alpha", type=float, default=256.0)
    ap.add_argument("--pp-stages", type=int, default=0,
                    help="pipeline-parallel decoder stages (0 = off)")
    ap.add_argument("--pp-microbatches", type=int, default=2)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's coordination service")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card of this rank, which must exist")
    return ap


def main(argv=None):
    ap = build_argparser()
    args = ap.parse_args(argv)

    import torch

    from trace_tpu_torch.data.dataset import EventDataset
    from trace_tpu_torch.model.config import TraceConfig
    from trace_tpu_torch.model.lora import add_lora_params
    from trace_tpu_torch.model.trace_model import tokens_per_frame
    from trace_tpu_torch.params import init_trace_params
    from trace_tpu_torch.tokenizers.text import ByteTokenizer
    from trace_tpu_torch.train.train import TrainRecipe, train_loop
    from trace_tpu_torch.runtime.distributed import (
        initialize,
        is_primary,
        local_device,
        process_count,
    )

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    # NCCL between cards, gloo between CPU ranks
    initialize(args.coordinator, args.num_processes, args.process_id,
               backend="gloo" if cpu else None)
    world = process_count()
    if args.pp_stages and (args.pp_stages > world or world % args.pp_stages):
        raise ValueError(f"--pp-stages {args.pp_stages} needs a multiple of as many processes "
                         f"(a rank a stage); there are {world}")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    device = local_device(args.device)
    mesh = pp_mesh = None
    if args.pp_stages:
        from trace_tpu_torch.parallel.pipeline import build_pp_mesh

        pp_mesh = build_pp_mesh(args.pp_stages, world, device=device)
        if is_primary():
            print(f"pipeline mesh: {pp_mesh.shape}")
    elif world > 1:
        from trace_tpu_torch.runtime.mesh import build_mesh

        mesh = build_mesh(args.mesh_devices or None, device=device)
        if is_primary():
            print(f"mesh: {mesh.shape} over {world} processes")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.init_checkpoint:
        from trace_tpu_torch.checkpoint.loader import load_pretrained
        from trace_tpu_torch.tokenizers.text import load_hf_tokenizer

        params, config = load_pretrained(args.init_checkpoint, vision_path=args.vision_path)
        tokenizer = load_hf_tokenizer(args.init_checkpoint)
    elif args.base_llm:
        # stage 0: base LLM + base CLIP + fresh multimodal modules
        # (reference trace_arch.py:60-186 initialize_*_modules)
        from trace_tpu_torch.checkpoint.convert import build_from_base_models
        from trace_tpu_torch.tokenizers.text import load_hf_tokenizer

        if not args.vision_path:
            ap.error("--base-llm requires --vision-path (CLIP dir)")
        params, config = build_from_base_models(
            args.base_llm, args.vision_path,
            mm_projector_path=args.pretrain_mm_adapter, generator=generator)
        tokenizer = load_hf_tokenizer(args.base_llm)
    else:
        config = TraceConfig.tiny()
        params = init_trace_params(config, generator)
        tokenizer = ByteTokenizer()
        print("WARNING: no --init-checkpoint; training a tiny random model")

    sample_scheme = args.sample_scheme or (
        "rand" if args.stage == "sft" else "uniform")
    dataset = EventDataset(
        args.data_path, tokenizer,
        data_folder=args.data_folder,
        num_frames=args.num_frames,
        num_video_tokens_per_frame=tokens_per_frame(config),
        max_len=args.max_len,
        sample_scheme=sample_scheme,
        image_size=config.vision.image_size,
        text_vocab_size=config.decoder.vocab_size,
        seed=args.seed,
    )

    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.epochs
    if args.stage == "pretrain":
        recipe = TrainRecipe.stage1(total_steps)
    elif args.stage == "lora":
        config = dataclasses.replace(
            config,
            decoder=dataclasses.replace(
                config.decoder, lora_r=args.lora_r, lora_alpha=args.lora_alpha),
        )
        params = dict(params)
        params["decoder"] = add_lora_params(
            params["decoder"], config.decoder, generator,
            targets=("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
        )
        recipe = TrainRecipe(stage="lora", learning_rate=1e-4, total_steps=total_steps)
    else:
        recipe = TrainRecipe.stage2(total_steps)
    if args.learning_rate is not None:
        recipe = TrainRecipe(
            stage=recipe.stage, learning_rate=args.learning_rate,
            projector_lr=args.projector_lr, total_steps=total_steps,
        )

    os.makedirs(args.output_dir, exist_ok=True)
    params, _, metrics = train_loop(
        params, config, dataset, recipe,
        batch_size=args.batch_size, mesh=mesh,
        checkpoint_dir=os.path.join(args.output_dir, "checkpoints"),
        save_every=args.save_steps,
        pp_mesh=pp_mesh, pp_microbatches=args.pp_microbatches,
        device=device,
    )
    if is_primary():
        print("final metrics:", {k: float(v) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
