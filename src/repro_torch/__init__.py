"""SIMDRAM on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package mirrors :mod:`repro`'s layout (``core/``, ``simdram/``,
``ops/``, ``kernels/``) and imports nothing of it: the compiler, trace IR,
timing model and scheduler are its own copies, the layout, backends,
machine and bbop surface are rewritten on ``torch`` tensors, and the two
kernels of the main path (the control-unit FSM and the transposition unit)
are hand-written CUDA under ``kernels/csrc/``.

Plane words are ``torch.int32``, bit-identical to the reference's uint32.
Entry points run on the card unless the caller asks for the CPU
(``SimdramMachine(device="cpu")``).
"""
