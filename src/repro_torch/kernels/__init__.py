"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
control-unit FSM (:mod:`.uprog_executor`), the transposition unit
(:mod:`.bitplane_transpose`) and the XNOR-popcount matmul of the
applications (:mod:`.bitserial_matmul`).  Sources live in ``csrc/`` and are
built with ``nvcc`` on first use (:mod:`._build`)."""
