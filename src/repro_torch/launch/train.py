"""Training launcher of the port: real steps on one device, the
reference's ``launch/train.py`` (without its ``--dry-run``, which belongs
to the distribution slice).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64
  # on the card (the default device), published widths:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 30 --batch 8 --seq 512

Vision and audio configs get zero media stand-ins, as the reference's
launcher gives them.  ``--checkpoint PATH`` writes the final state (the
reference's ``.npz`` layout).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import BigramDataPipeline
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def with_media(cfg, batch: dict, batch_size: int) -> dict:
    """``batch`` plus zero ``image_embeds`` / ``audio_frames`` for a vision
    or audio config (float32, the reference's stand-ins)."""
    out = dict(batch)
    if cfg.vision is not None:
        out["image_embeds"] = torch.zeros(
            (batch_size, cfg.vision.num_image_tokens, cfg.vision.embed_dim))
    if cfg.audio is not None:
        out["audio_frames"] = torch.zeros(
            (batch_size, cfg.audio.num_frames, cfg.audio.embed_dim))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (CPU-sized) config variant")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each repeat group in the backward pass")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} device={device}")

    data = BigramDataPipeline(cfg.vocab_size, args.seq, args.batch,
                              seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, gen, device=device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat,
                              microbatches=args.microbatches)

    t0 = time.time()
    first_loss = last_loss = None
    for step, batch in zip(range(args.steps), data):
        state, metrics = step_fn(state, with_media(cfg, batch, args.batch))
        loss = metrics["loss"]
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        if step % args.log_every == 0 or step == args.steps - 1:
            tput = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lm {metrics['lm_loss']:.4f}  "
                  f"gnorm {metrics['grad_norm']:.2f}  "
                  f"{tput:,.0f} tok/s", flush=True)

    print(f"loss: {first_loss:.4f} -> {last_loss:.4f} "
          f"({'improved' if last_loss < first_loss else 'NOT improved'})")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, step=args.steps)
        print(f"checkpoint -> {args.checkpoint}")
    return {"first_loss": first_loss, "last_loss": last_loss,
            "steps": args.steps}


if __name__ == "__main__":
    main()
