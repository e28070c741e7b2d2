"""End-to-end example: train a ~111M-parameter LM with the port's training
stack on one device — fault-tolerant loop, checkpointing, synthetic data.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300 \
        [--device cpu]

(defaults to a short smoke run; pass --steps 300 for the full example).
Runs on ``cuda`` unless ``--device`` says otherwise; exits 0 iff the loss
improved.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.failover import FailoverConfig, FailoverRunner
from repro_torch.launch.train import setup
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.optimizer import AdamWConfig

# 111,096,960 params (the reference's comment says ~105M): 10 layers ×
# d=640 + 50k vocab (untied)
CONFIG_100M = ModelConfig(
    name="repro-100m", family="dense", n_layers=10, d_model=640,
    n_heads=10, n_kv_heads=5, d_ff=1792, vocab=50304, remat="none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_100m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: %(default)s)")
    args = ap.parse_args(argv)

    cfg = CONFIG_100M
    opt = AdamWConfig(lr=6e-4, total_steps=args.steps,
                      warmup_steps=max(5, args.steps // 20))
    state, _, step = setup(cfg, None, opt, device=args.device)
    n = sum(p.numel() for p in state.params.parameters())
    print(f"{cfg.name}: {n/1e6:.1f}M params on {args.device}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt)
    runner = FailoverRunner(step, ckpt, FailoverConfig(checkpoint_every=100))
    try:
        state, history = runner.run(
            state, lambda s: synthetic_batch(dcfg, s, device=args.device),
            0, args.steps)
    finally:
        ckpt.close()
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if runner.monitor.flagged:
        print("stragglers:", runner.monitor.flagged)
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
