"""End-to-end training launcher on one device.

Wires configs → model and optimizer state → data pipeline → training loop
with periodic checkpoints (resuming from the latest one in ``--ckpt-dir``).
The reference's launcher (:mod:`repro.launch.train`) on one device: there is
no mesh, and the majority-vote compressed data parallelism
(``--compressed``) needs ``torch.distributed``, which the port does not use
yet, so the flag is refused.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 200 --batch 8 --seq 256 [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise.  Exits 0 iff the last
logged loss is below the first.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..distributed.checkpoint import CheckpointManager
from ..models.transformer import Transformer
from ..train.data import DataConfig, synthetic_batch
from ..train.optimizer import AdamWConfig
from ..train.train_step import init_train_state, make_train_step


def setup(cfg, opt_cfg: AdamWConfig, microbatches: int = 1, seed: int = 0,
          device="cuda"):
    """``(state, step)``: the model of ``cfg`` on ``device``, its parameters
    drawn in place from a generator seeded with ``seed``, a fresh AdamW
    state, and the train step."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Transformer(cfg, device=dev).draw_params(gen)
    state = init_train_state(model)
    return state, make_train_step(cfg, opt_cfg, microbatches=microbatches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compressed", action="store_true",
                    help="majority-vote 1-bit gradient all-reduce (needs "
                         "torch.distributed; not ported yet)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: %(default)s)")
    args = ap.parse_args(argv)
    if args.compressed:
        print("--compressed: the majority-vote exchange runs between "
              "data-parallel replicas over torch.distributed, which this "
              "single-device launcher does not use yet", file=sys.stderr)
        return 2

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    device = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    state, step = setup(cfg, opt_cfg, microbatches=args.microbatches,
                        device=device)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device} "
          f"compressed={args.compressed}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = ckpt.latest_step() or 0
    if start:
        state = ckpt.restore(start, state)
        print(f"resumed from checkpoint step {start}")

    t0 = time.time()
    losses = []
    try:
        for s in range(start, args.steps):
            state, metrics = step(state, synthetic_batch(dcfg, s,
                                                         device=device))
            if s % args.log_every == 0 or s == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                print(f"step {s:5d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0):.1f}s)")
            if (s + 1) % args.ckpt_every == 0:
                ckpt.save(s + 1, state)
    finally:
        ckpt.close()
    if not losses:
        print(f"nothing to train: the checkpoint in {args.ckpt_dir} is at "
              f"step {start}, --steps is {args.steps}")
        return 1
    print(f"final loss {losses[-1]:.4f} (initial {losses[0]:.4f})")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
