"""Train a small dense model for a few hundred steps on the synthetic
bigram corpus and checkpoint it — the full training substrate of the port
(data pipeline -> train step -> AdamW -> checkpoint), the reference's
``examples/train_tiny.py``.  The checkpoint round trip at the end restores
every leaf bit for bit, bf16 models' too (``--arch qwen2-0.5b``).

  PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 200] \\
      [--device cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import BigramDataPipeline
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.train_step import init_train_state, make_train_step


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-0.6b-toy")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default=None,
                    help="where to write the checkpoint (default: a "
                         "temporary directory)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"on {device}")

    b, s = 8, 64
    data = BigramDataPipeline(min(cfg.vocab_size, 512), s, b, seed=0)
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0),
                             device=device)
    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, remat=False)

    t0, losses = time.time(), []
    for i in range(args.steps):
        state, m = step_fn(state, data.batch(i))
        losses.append(m["loss"])
        if i % 20 == 0 or i == args.steps - 1:
            tput = b * s * (i + 1) / (time.time() - t0)
            print(f"  step {i:4d} loss={losses[-1]:.4f} "
                  f"lr={m['lr']:.2e} {tput:,.0f} tok/s")

    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(Δ={losses[0]-losses[-1]:+.3f})")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.checkpoint or os.path.join(tmp, "repro_tiny.npz")
        save_checkpoint(path, state, step=args.steps)
        restored = restore_checkpoint(path, state)
    ok = all(a.dtype == b_.dtype and torch.equal(a, b_) for a, b_ in
             zip(tree_leaves(state), tree_leaves(restored)))
    print("checkpoint roundtrip OK:", ok)
    return ok


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
