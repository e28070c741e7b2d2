"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version: the control-unit FSM (:mod:`.uprog_executor`) and the
transposition unit (:mod:`.bitplane_transpose`).  Sources live in
``csrc/`` and are built with ``nvcc`` on first use (:mod:`._build`)."""
