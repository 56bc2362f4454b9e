"""Training CLI of the PyTorch port (counterpart of ``f5tts_tpu/cli/train.py``).

    python -m f5tts_tpu_torch.cli.train --smoke --device cpu     # 3 synthetic steps, tiny model
    python -m f5tts_tpu_torch.cli.train --model F5TTS_Base --vocab-file vocab.txt \\
        --dataset-dir data/ --checkpoint-dir ckpts/run0

One device, bf16 compute over fp32 params, AdamW or ``--optimizer
adafactor``; ``F5TTS_*`` train the DiT, ``E2TTS_*`` the UNetT. ``--attn
flash`` (the default) trains through the hand-written attention kernels,
``plain`` through the plain PyTorch attention. ``--sample-every N``
synthesizes the first batch's prompts from the EMA weights every N updates
(``--sample-nfe``; ``--sample-vocoder`` a converted Vocos ``.npz`` for wavs)
into ``<checkpoint-dir>/samples``. Runs on ``cuda`` unless ``--device cpu``;
with no GPU and no ``--device cpu`` it raises. ``--train-config`` reads a
YAML config (``configs/*.yaml``; PyYAML is imported only then; its
``bnb_optimizer`` maps to ``adafactor``).

Multi-device: one process per device, started with the launcher's variables
(``parallel/launcher.py``); with more than one process the CLI builds the
``(data, model)`` mesh with ``--model-parallel`` ranks per model group::

    COORDINATOR_ADDRESS=localhost:29500 NUM_PROCESSES=4 PROCESS_ID=$i LOCAL_RANK=$i \
        python -m f5tts_tpu_torch.cli.train --smoke --model-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses

MODEL_NAMES = ("F5TTS_Base", "F5TTS_Small", "E2TTS_Base", "E2TTS_Small", "demo_tiny")


def resolve_model_cfg(name: str, vocab_file: str = ""):
    """``F5TTS_*`` -> the DiT, ``E2TTS_*`` -> the UNetT (vocab size from the
    vocab file), or the tiny smoke model."""
    from f5tts_tpu_torch.models.cfm import CFMConfig
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.unett import UNetTConfig

    if name == "demo_tiny":
        return CFMConfig(model=DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
                                         text_num_embeds=256, text_dim=32, conv_layers=1, max_pos=512))
    base = {"F5TTS_Base": DiTConfig.base, "F5TTS_Small": DiTConfig.small, "E2TTS_Base": UNetTConfig.base,
            "E2TTS_Small": UNetTConfig.small}[name]()
    if vocab_file:
        from f5tts_tpu_torch.text.tokenizer import Tokenizer

        base = dataclasses.replace(base, text_num_embeds=Tokenizer.from_file(vocab_file).vocab_size)
    return CFMConfig(model=base)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("f5tts_tpu_torch.cli.train", description="F5-TTS training (PyTorch / CUDA)")
    p.add_argument("--dataset-dir", default="", help="directory with a manifest.jsonl")
    p.add_argument("--vocab-file", default="")
    p.add_argument("--model", default="F5TTS_Base", choices=list(MODEL_NAMES))
    p.add_argument("--checkpoint-dir", default="ckpts/run0")
    p.add_argument("--learning-rate", type=float, default=7.5e-5)
    p.add_argument("--warmup-updates", type=int, default=20000)
    p.add_argument("--total-updates", type=int, default=1200000)
    p.add_argument("--batch-frames", type=int, default=38400)
    p.add_argument("--grad-accum", type=int, default=1, help="micro-batches per optimizer update")
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"],
                   help="adafactor = factored second moments, about half AdamW's optimizer memory")
    p.add_argument("--max-samples", type=int, default=64)
    p.add_argument("--attn", default="flash", choices=["flash", "plain"],
                   help="flash = the hand-written kernels, plain = plain PyTorch attention")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=10000)
    p.add_argument("--sample-every", type=int, default=0,
                   help="synthesize fixed prompts from the EMA weights every N updates; 0 = off")
    p.add_argument("--sample-nfe", type=int, default=16)
    p.add_argument("--sample-vocoder", default="",
                   help="converted Vocos .npz: the sample hook also writes 24 kHz wavs")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel ranks per model group (multi-process runs; see the module docstring)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--smoke", action="store_true", help="tiny model + synthetic data, 3 steps")
    p.add_argument("--train-config", default="", help="YAML training config (configs/*.yaml); flags override")
    return p


def apply_train_config(p: argparse.ArgumentParser, args) -> None:
    """Fill ``args`` from ``--train-config`` where a flag was left at its default."""
    import yaml

    with open(args.train_config, encoding="utf-8") as f:
        ycfg = yaml.safe_load(f)
    model, optim, ckpts = ycfg.get("model", {}), ycfg.get("optim", {}), ycfg.get("ckpts", {})
    defaults = {a.dest: a.default for a in p._actions}
    mapping = {
        "model": model.get("name"), "vocab_file": model.get("vocab_file"),
        "learning_rate": optim.get("learning_rate"), "warmup_updates": optim.get("warmup_updates"),
        "total_updates": optim.get("total_updates"), "batch_frames": optim.get("batch_frames"),
        "grad_accum": optim.get("grad_accum"), "max_samples": optim.get("max_samples"),
        # the reference's configs carry bnb_optimizer (8-bit AdamW): Adafactor takes its memory role
        "optimizer": optim.get("optimizer", "adafactor" if optim.get("bnb_optimizer") else None),
        "checkpoint_dir": ckpts.get("checkpoint_dir"), "save_every": ckpts.get("save_every"),
        "log_every": ckpts.get("log_every"),
    }
    for dest, val in mapping.items():
        if val not in (None, "") and getattr(args, dest) == defaults.get(dest):
            setattr(args, dest, val)


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    if args.train_config:
        apply_train_config(p, args)

    import torch

    from f5tts_tpu_torch.parallel.launcher import global_mesh, init_distributed
    from f5tts_tpu_torch.train.metrics import JsonlLogger
    from f5tts_tpu_torch.train.trainer import TrainConfig, Trainer

    _, n_proc = init_distributed(device=args.device)
    if n_proc == 1 and args.model_parallel > 1:
        raise SystemExit("--model-parallel > 1 needs several processes (NUM_PROCESSES, see the module docstring)")
    mesh = global_mesh(args.model_parallel, device=args.device) if n_proc > 1 else None

    name = "demo_tiny" if args.smoke else args.model
    model_cfg = resolve_model_cfg(name, args.vocab_file if name != "demo_tiny" else "")
    model_cfg = dataclasses.replace(model_cfg, model=dataclasses.replace(
        model_cfg.model, attn_impl=args.attn, conv_pos_impl="fused" if args.attn == "flash" else "plain"))
    train_cfg = TrainConfig(learning_rate=args.learning_rate, warmup_updates=args.warmup_updates,
                            total_updates=args.total_updates, seed=args.seed, max_grad_accum=args.grad_accum,
                            optimizer=args.optimizer)
    logger = JsonlLogger()
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=getattr(torch, args.dtype),
                      checkpoint_dir=None if args.smoke else args.checkpoint_dir, log_every=args.log_every,
                      save_every=args.save_every, logger=logger, device=args.device,
                      sample_every=args.sample_every or None, mesh=mesh)
    state, start = trainer.init_or_resume()

    def build_sample_hook(first_batch):
        if not args.sample_every:
            return None
        import os

        from f5tts_tpu_torch.train.sample_hook import make_sample_hook, prompts_from_batch

        vocoder = None
        if args.sample_vocoder:
            from f5tts_tpu_torch.models.convert import load_params_npz
            from f5tts_tpu_torch.models.vocos import VocosConfig

            vocoder = (load_params_npz(args.sample_vocoder), VocosConfig(input_channels=model_cfg.model.mel_dim))
        return make_sample_hook(model_cfg, os.path.join(args.checkpoint_dir, "samples"),
                                prompts_from_batch(first_batch), nfe_step=args.sample_nfe, vocoder=vocoder,
                                logger=logger)

    if args.smoke:
        from f5tts_tpu_torch.train.data import synthetic_batches

        trainer.log_every = 1
        # the batch's rows divide over the mesh's data axis
        smoke_batch = max(2, n_proc) if mesh is not None else 2
        batches = list(synthetic_batches(model_cfg.model, frames=256, batch=smoke_batch, n_batches=3, seed=args.seed))
        trainer.sample_hook = build_sample_hook(batches[0])
        state = trainer.fit(state, batches, total_updates=3)
        if trainer.lead:
            print(f"smoke ok: step={state['step']}")
        return state

    from f5tts_tpu_torch.train.data import FramePackedDataset

    ds = FramePackedDataset.from_dir(args.dataset_dir, vocab_file=args.vocab_file)
    batches = ds.batches(batch_frames=args.batch_frames, max_samples=args.max_samples, seed=args.seed,
                         skip_batches=start)
    if args.sample_every:  # the first batch gives the fixed prompt set, then goes back in front
        import itertools

        first = next(batches)
        trainer.sample_hook = build_sample_hook(first)
        batches = itertools.chain([first], batches)
    # batches() is an infinite epoch iterator: the update budget is the stop
    return trainer.fit(state, batches, total_updates=max(args.total_updates - start, 0))


if __name__ == "__main__":
    main()
