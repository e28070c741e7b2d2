"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
control-unit FSM (:mod:`.uprog_executor`), the transposition unit
(:mod:`.bitplane_transpose`), the XNOR-popcount matmul of the applications
(:mod:`.bitserial_matmul`) and the models layer's one-token attention over
a KV cache (:mod:`.decode_attention`).  Sources live in ``csrc/`` and are
built with ``nvcc`` on first use (:mod:`._build`)."""
