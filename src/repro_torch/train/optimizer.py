"""AdamW on ``torch`` tensors, with the reference's arithmetic
(:mod:`repro.train.optimizer`): the gradients clipped by their global norm
first, bias corrections and the cosine schedule in float32, weight decay
inside the update direction.  ``torch.optim.AdamW`` places the decay and
epsilon otherwise and rounds differently, so it is not used.

The state is keyed like the parameters: ``m`` and ``v`` are dicts of
float32 tensors with the parameters' names, ``step`` an int32 scalar on
the CPU (so the schedule and bias corrections are host scalars and no step
waits on the device).  :func:`adamw_update` works in place: at full width
the reference's functional copies would hold the ~7.4 GB of parameters,
``m`` and ``v`` of Qwen1.5-0.5B twice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import tree_leaves


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor          # int32 scalar, on the CPU
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params: dict) -> AdamWState:
    """Zeroed float32 moments keyed like ``params`` (name → tensor)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to a tenth: a float32 scalar on the
    CPU, computed one float32 op at a time as the reference does."""
    step = torch.as_tensor(step, dtype=torch.int32, device="cpu")
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree) -> torch.Tensor:
    """√(Σ g²) over every leaf of a (nested) dict of tensors on one device,
    in float32."""
    leaves = [g.float() for _, g in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, state: AdamWState, params: dict,
                 grads: dict):
    """One AdamW step, in place: ``grads`` are scaled by the clip factor,
    ``params``, ``state.m`` and ``state.v`` (dicts with the same keys, one
    device) are updated.  Returns ``(params, AdamWState(step + 1, m, v),
    {"grad_norm", "lr"})``; ``grad_norm`` is the norm before clipping, a
    scalar on the parameters' device."""
    keys = list(params)
    p, g = [params[k] for k in keys], [grads[k] for k in keys]
    m, v = [state.m[k] for k in keys], [state.v[k] for k in keys]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    torch._foreach_mul_(g, scale)
    step = state.step + 1
    lr = float(lr_schedule(cfg, step))
    stepf = step.float()
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
    delta = torch._foreach_div(m, b1c)               # m̂
    denom = torch._foreach_div(v, b2c)               # v̂
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_div_(delta, denom)
    del denom
    torch._foreach_add_(delta, p, alpha=cfg.weight_decay)
    torch._foreach_add_(p, delta, alpha=-lr)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm,
        "lr": torch.tensor(lr, dtype=torch.float32)}
