"""Fault-tolerant training loop: checkpoint/restart, step retry and
straggler detection.

The reference's runner (:mod:`repro.distributed.failover`) with injectable
failure hooks, so the logic is testable on one host:

  * every step runs under retry: an exception re-runs the step from the
    last committed state.  The port's steps update the state in place; the
    retry is exact because they do so only after the loss and backward
    pass have succeeded (:mod:`repro_torch.train.train_step`), so a step
    that raises before its update leaves the state as it was;
  * a persistent failure restores the latest checkpoint into the state;
  * per-step wall times feed a straggler monitor: any step slower than
    ``straggler_factor`` × the running median is logged and counted; on a
    real deployment this triggers hot-spare swap-in (hook provided).

A step's time ends with a synchronize on its first metric's device, so it
counts the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from .checkpoint import CheckpointManager


@dataclasses.dataclass
class FailoverConfig:
    checkpoint_every: int = 50
    max_retries: int = 2
    straggler_factor: float = 3.0
    keep_times: int = 64


class StragglerMonitor:
    def __init__(self, factor: float, keep: int = 64) -> None:
        self.factor = factor
        self.times: list[float] = []
        self.keep = keep
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                is_straggler = True
        self.times.append(dt)
        self.times = self.times[-self.keep:]
        return is_straggler


def _wait_for(metrics: dict) -> None:
    """Wait until the device that holds the first metric has finished."""
    first = next(iter(metrics.values()), None)
    if isinstance(first, torch.Tensor) and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


class FailoverRunner:
    """Drives (state, batch) → (state, metrics) steps with checkpoint/
    restart."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: FailoverConfig | None = None,
                 on_straggler: Callable[[int], None] | None = None,
                 failure_injector: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg or FailoverConfig()
        self.monitor = StragglerMonitor(self.cfg.straggler_factor,
                                        self.cfg.keep_times)
        self.on_straggler = on_straggler or (lambda step: None)
        self.failure_injector = failure_injector
        self.events: list[str] = []

    def run(self, state, batch_fn: Callable[[int], Any], start_step: int,
            num_steps: int, mesh=None, shardings=None):
        """Run ``num_steps`` steps with retry + periodic checkpointing.
        ``mesh`` is recorded in each checkpoint, ``shardings`` passed to a
        restore (:meth:`CheckpointManager.restore`).  Returns (state,
        metrics_history)."""
        history = []
        step = start_step
        while step < start_step + num_steps:
            batch = batch_fn(step)
            t0 = time.monotonic()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(step)
                    new_state, metrics = self.step_fn(state, batch)
                    _wait_for(metrics)
                    break
                except Exception as e:   # noqa: BLE001 — retry then restore
                    self.events.append(f"step {step} attempt {attempt} "
                                       f"failed: {type(e).__name__}")
                    if attempt >= self.cfg.max_retries:
                        state = self._restore(state, shardings)
                        step = int(state.opt.step)
                        self.events.append(f"restored at step {step}")
                        new_state, metrics = None, None
                        break
            if new_state is None:
                continue
            state = new_state
            dt = time.monotonic() - t0
            if self.monitor.record(step, dt):
                self.events.append(f"straggler at step {step}: {dt:.3f}s")
                self.on_straggler(step)
            history.append({k: float(v) for k, v in metrics.items()})
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, state, mesh)
        self.ckpt.save(step, state, mesh, blocking=True)
        return state, history

    def _restore(self, like_state, shardings=None):
        self.ckpt.wait()       # a periodic save may still be writing
        latest = self.ckpt.latest_step()
        if latest is None:
            raise RuntimeError("no checkpoint to restore from")
        return self.ckpt.restore(latest, like_state, shardings)
