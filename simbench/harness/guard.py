"""The check that the process measured none of the JAX side.

Modules are compared by their top-level name (the part before the first
dot) taken whole: ``repro_torch`` begins with ``repro`` and is allowed,
``repro.core`` is not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def top_level(name: str) -> str:
    return name.partition(".")[0]


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (``sys.modules`` unless ``names`` is given) whose
    top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
