#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SIMDRAM (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--ab-old [KERNEL=]OLD.cu ...]

Phases, each fatal on failure:

1. print the card (``nvidia-smi``) and build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (timed);
2. the transposition kernels against their plain PyTorch versions, both
   directions, n_bits 1/3/8/16/31/32, signed and unsigned, at 16 × 65,536
   lanes and at a group count that is not a multiple of 32; and every
   n_bits 1–32 at 37 groups (below one block) and 300 (not a multiple of
   one block's 128);
3. the FSM kernel against its plain version on banked 16 × 2,048-word row
   files: all 16 builtins at 8 bits, addition/multiplication/division at 32
   bits and one fused chain trace; and on seeded synthetic streams whose
   ports alias (MAJ with a == b or a == -c, COPY onto its own source) at
   R 3/32/235 on 3 × 97 words, N 600 (above one staged chunk of 256 and
   not a multiple of it); and the μProgram-level entry
   ``run_uprogram_kernel`` on the card against its CPU run, exactly, at
   addition, greater and if_else, 8 bits, 16 × 2,048 words;
2b. the XNOR-popcount kernel against its plain version at VGG-16's
   binarized FC6 and FC7 (batch 256), the applications example's layer, a
   ragged edge (M 33, N 100, K 160), a K tail after a whole k-tile (M 17,
   N 9, K 1,056) and one row (M 1, N 4,096, K 32); FC6 twice, bit-identical
   (its K is split across a cluster of blocks);
4. the main path on ``SimdramMachine(device="cuda", banks=16,
   mode="replay")`` at 16 × 65,536 lanes — the quickstart flow, every value
   checked against numpy, with the kernels' launch counters read around it;
4b. the applications path (``repro_torch.apps``) at 16 × 65,536 lanes on
   the ``unrolled`` backend, as the reference example runs it, and on the
   default ``kernel`` backend: brightness on a 1,024 × 1,024 image, a
   BitWeaving scan over 4,194,304 codes (four passes), masked darken through
   the user-defined ``gated_sub``, and the XNOR layer at FC6 and FC7, every
   value checked against numpy, launch counters read around each pass;
4c. the serving path: ``SimdramServer(n_machines=2, n_banks=16,
   device="cuda", mode="replay")`` with 32 users on the serving
   benchmark's mix (qwen1_5_0_5b, mamba2_130m, whisper_large_v3,
   olmoe_1b_7b, round-robin), 16 tokens each, arrivals 200 modeled ns
   apart; every session's final value checked against a numpy replay of
   its recurrence, and the ``ServingStats`` snapshot against the same run
   on ``device="cpu"`` (the plain kernel versions), exactly;
4d. the in-DRAM greedy sampler: ``simdram_greedy_token`` on seeded
   float32 logits (16, 151,936) (Qwen1.5-0.5B's vocabulary) with a few
   ``-inf`` entries, under a ``PerfStats``; token ids, quantized logits and
   the ``PerfStats`` snapshot checked against the CPU run, exactly, and
   54 μPrograms and 3 transposition passes a call;
4e. the LM serving path: Qwen1.5-0.5B at full width (24 layers, d_model
   1,024, vocab 151,936, bf16 compute, parameters drawn on the card from a
   seed) greedily decodes 32 tokens for 16 sequences after a 128-token
   prompt, through ``repro_torch.serve.decode.greedy_decode`` with the host
   sampler and with the in-DRAM sampler (``SimdramMachine(device="cuda",
   banks=16)``, the FSM and transposition kernels); checks (a) cached
   decode == no-cache forward at full width in float32 (2 layers, 12
   steps, 2e-3), (b) each sampled token is a maximal quantized logit of its
   step, (c) the same pick as the ``unrolled`` backend, (d) the reduced
   config on the card == the CPU within the bf16 tolerance, (e) the
   XNOR-popcount kernel on the full-width pum gate operands == the einsum
   of their signs, exactly; prints prefill and per-token times (CUDA
   events around every forward of the same ``greedy_decode`` run; a token
   is one cached step forward and its pick), launches a token, the
   sampler's modeled ns/nJ a token, the device's busy share and the torch
   ops the host issues a decode step;
4f. the MoE serving path: checks (a) as in 4e at full width for
   OLMoE-1B-7B and DeepSeek-V2-236B (2 layers each, capacity factor
   ceil(E / k), so no token drops) and Mamba2-130m (24 layers); then
   OLMoE-1B-7B at full width and depth (16 layers, d_model 2,048, 64
   experts top-8, d_expert 1,024, vocab 50,304, bf16 compute, drawn in
   place on the card from a seed) greedily decodes 32 tokens for 16
   sequences after a 128-token prompt with each sampler, timed as in 4e,
   checks (b) and (c); (d) the reduced config of each of OLMoE,
   DeepSeek-V2, Mamba2, Zamba2 and Whisper (primed from its encoder
   frames) on the card == the CPU within the bf16 tolerance, MoE routes
   first; prints the peak memory allocated, launches a token, the
   sampler's modeled ns/nJ a token and the device's busy share;
4g. the training path: Qwen1.5-0.5B at full width and depth (24 layers,
   d_model 1,024, vocab 151,936, tied embeddings, bf16 compute, remat
   "full", parameters drawn on the card from a seed) trains 20 steps
   through ``repro_torch.launch.train.setup`` and its step on
   ``synthetic_batch`` at the launcher's defaults (8 × 256 tokens), no
   checkpoint at that size; the loss must fall; prints the ms a training
   step (median of steps 3–20, CUDA events around each step), tokens/s,
   model-FLOPs utilisation against 989 TFLOP/s bf16, peak memory, and,
   under the profiler, the device's busy share over one step, the host's
   torch ops a step and one AdamW update alone; checks (a) one step at
   full width cut to 2 layers in float32 (batch 2 × 64) on the card ==
   the CPU (objective, ``grad_norm`` and every gradient within 1e-4 ×
   max|·|, parameters within 2 · lr), (b) 3 steps of the reduced config
   of each family (dense, vlm, MoE, MLA, SSM, hybrid, enc-dec) on the card
   == the CPU within 5e-2, (c) a ``CheckpointManager`` save and restore is
   exact and the resumed losses equal the uninterrupted run's within 1e-6
   relative, (d) ``microbatches=2`` and ``loss_chunk=16`` equal the plain
   step within the CPU tests' tolerances; then runs
   ``repro_torch.examples.train_100m`` at its defaults (111 M parameters,
   20 steps), which must exit 0; the kernels' launch counters must read
   0 through the whole phase;
4h. the distributed path: (a) 4g's model, batches and schedule through
   ``launch.train.setup(..., compressed=True, exchange="packed")`` on a
   (1, 1) mesh over an NCCL process group of one rank, 20 steps; the loss
   must fall; check: on the first batch's gradients the vote (pack,
   all-gather, majority, scale) equals sign(g + e) · mean|g + e| of every
   leaf computed plainly (signs exact, scales within 1e-6); prints the ms
   a step (CUDA events), the vote alone on those gradients (whole, and
   its parts, timed by events at the marks of the step's own exchange),
   the packed bytes against a float32
   all-reduce's, peak memory, and 10 plain steps through ``setup`` on the
   same mesh; (b) 4 processes on the one card over gloo (the eager
   collectives take CUDA tensors; DTensor's functional all-gather is
   staged through host memory), joined with a timeout: 3 steps of the
   ``packed``, ``psum`` and ``two_phase`` exchanges at the reduced config
   (float32) against the same 4 ranks on the CPU (losses within 1e-5
   relative, parameters within 1e-5 but for at most one, or 0.1 %, of a
   leaf's elements, whose vote turned, within 2 · lr a step; every rank
   equal), the
   pipeline at the reference test's shapes against the sequential
   composition (forward 1e-5, gradients 1e-4), and the sharded plain step
   on a (2, 2) mesh against one rank (1e-4; parameters within lr a step);
   the launch counters, this process's and each spawned rank's (saved
   beside its results), must read 0;
4i. (run after 4f, before 4g) the hybrid and enc-dec serving paths:
   checks (a) as in 4e at full width for Zamba2-7B (12 layers, two calls
   of the shared block) and Whisper-large-v3 (2 + 2 layers over all 1,500
   encoder frames, drawn from a seed, which prime the cached run's caches
   and join every forward); then Zamba2-7B (81 SSM layers, d_model 3,584,
   112 SSM heads, the weight-tied attention block called 13 times, vocab
   32,000) and Whisper-large-v3 (32 + 32 layers, d_model 1,280, vocab
   51,866, encoder frames (16, 1,500, 1,280) bf16 through ``greedy_decode``'s
   ``extra_batch``), each at full width and depth, drawn in place on the
   card from a seed, bf16 compute, greedily decode 32 tokens for 16
   sequences after a 128-token prompt with each sampler, timed as in 4e,
   checks (b) and (c), 3·log2(padded vocab) − 3 FSM and 3 transposition
   launches a token (45 and 48 FSM); prints peak memory, Whisper's
   priming of its caches, the device's busy share, the copy kernels' device
   time (the per-use weight casts), the torch ops a decode step and the
   sampler's modeled ns/nJ a token, each model freed before the next;
5. (run before 4e, printed after it) kernel times with CUDA events and
   the profiler (a trace that lost kernel events against the launch
   counter is taken again) beside the plain versions', the bound and, for the XNOR kernel, ``torch._int_mm``; the
   FSM at multiplication/8b and division/32b; the transposition kernels at
   1, 8 and 32 planes, with their inputs rotating past the L2 and with one
   input (``kernel_warm_ms``), beside the profiler time of a PyTorch copy
   of the same element vector (``copy_ms``, a yardstick only).

``--ab-old [KERNEL=]OLD.cu`` (optional, repeatable) also builds an earlier
version of ``csrc/KERNEL.cu`` with the same C interface, copies it to
``chiprun_out/ab/``, checks it equal to the current kernel and times both
in turns, on the same inputs, by CUDA events and by the profiler's kernel
time; the times go to ``chiprun_out/ab/ab.json``.  KERNEL is

- ``bitserial_matmul`` (the default when ``KERNEL=`` is left out; the C
  interface before the kernel's ``wgmma`` design, ``bitserial_matmul_launch(a,
  b, out, m, n, kw, k_bits, device, stream)``): old, new,
  ``torch._int_mm``, ``torch._int_mm``, new, old at FC6 and FC7;
- ``uprog_executor``: old, new, new, old at multiplication/8b and
  division/32b on 16 × 2,048-word row files;
- ``bitplane_transpose``: to planes, old, new, new, old at 1, 8 and 32
  planes × 16 × 65,536 lanes.

An earlier source comes from git, e.g.
``git show 9a3d5b9:src/repro_torch/kernels/csrc/uprog_executor.cu``, into
a git-ignored directory such as ``build/ab_old/``.

Phases 4, 4b, 4c, 4d, 4e, 4f and 4i each set every kernel's launch counter
to 0 before the path and fail if a kernel of that path did not launch
(the LM paths count one in-DRAM-sampler ``greedy_decode``); phases 4g
and 4h set them to 0 and fail if any kernel launched (no SIMDRAM kernel lies
on the training or the distributed path).  Every
comparison of integers is exact; float logits are compared within the
stated tolerances.  The last line is the
``{"ok": true, "device": ...}`` object; the line before it names the card
and its power limit; the ``{"kernels": [...]}`` line comes before that.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BANKS = 16
LANES = 65_536                  # bitlines of one 8 KB DRAM row
WORDS = LANES // 32             # plane words per bank
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
INT32_LANES_PER_SM = 64         # Hopper SM: 4 partitions × 16 INT32 lanes
POPC_PER_SM = 16                # __popc a clock an SM, compute capability 9.0
                                # (CUDA C++ Programming Guide, throughput table)
INT8_TC_OPS_PER_S = 1979e12     # H100 SXM dense INT8 tensor cores (data sheet)
# (label, M, N, K) of the XNOR layers: VGG-16's binarized fully-connected
# layers at batch 256 (FC6: K = 512·7·7; FC7), the applications example's
# layer, and a ragged edge
XNOR_SHAPES = (("fc6", 256, 4096, 25088), ("fc7", 256, 4096, 4096),
               ("example", 128, 128, 256), ("edge", 33, 100, 160),
               ("k_tail", 17, 9, 1056), ("one_row", 1, 4096, 32))
TRANSPOSE_BITS = (1, 3, 8, 16, 31, 32)   # phase 2's plane counts
SMALL_GROUPS = (37, 300)        # below one to-planes block; not a multiple
# (R, N) of phase 3's synthetic streams: N above one staged chunk of 256
# commands and not a multiple of it
ALIASED_STREAMS = ((3, 600), (32, 600), (235, 600))
# phase 3's μProgram-level entry at 8 bits: op → (input planes, out_bits)
UPROGRAM_CASES = {"addition": ({"a": 8, "b": 8}, None),
                  "greater": ({"a": 8, "b": 8}, {"out": 1}),
                  "if_else": ({"a": 8, "b": 8, "sel": 1}, None)}
FSM_TIMED = (("multiplication", 8), ("division", 32))
APP_IMAGE = (1024, 1024)        # 16 banks × 65,536 lanes: one full pass
APP_CODES = 4 * BANKS * LANES   # four passes of the scan
SEED = 0x51D0
# phase 4c: the serving benchmark's request mix (benchmarks/bench_serving.py)
SERVE_MIX = ("qwen1_5_0_5b", "mamba2_130m", "whisper_large_v3",
             "olmoe_1b_7b")
SERVE_USERS, SERVE_TOKENS, SERVE_GAP_NS = 32, 16, 200.0
# phase 4d: a decode batch of 16 over Qwen1.5-0.5B's vocabulary
SAMPLER_SHAPE = (16, 151_936)
SAMPLER_WARM_CALLS = 5
# phase 4e: Qwen1.5-0.5B at full width, 16 sequences, a 128-token prompt
# and 32 new tokens; checks (a) at 2 layers and 12 steps
LM_ARCH = "qwen1.5-0.5b"
LM_BATCH, LM_PROMPT, LM_NEW = 16, 128, 32
LM_CHECK_LAYERS, LM_CHECK_STEPS = 2, 12
LM_REPEATS = 3                  # warm timings of the prefill and each sampler
LM_SELF_ABS, LM_BF16_REL = 2e-3, 5e-2     # the CPU tests' tolerances
# phase 4f: OLMoE-1B-7B at full width and depth, 4e's shape; checks (a)
# at full width, (arch, layers) with None the full depth; check (d) on
# the reduced config of every family 4f brings
MOE_ARCH = "olmoe-1b-7b"
MOE_REPEATS = 3
MOE_CHECKS = (("olmoe-1b-7b", 2), ("deepseek-v2-236b", 2),
              ("mamba2-130m", None))
REDUCED_FAMILIES = ("olmoe-1b-7b", "deepseek-v2-236b", "mamba2-130m",
                    "zamba2-7b", "whisper-large-v3")
# phase 4i: Zamba2-7B (hybrid) and Whisper-large-v3 (enc-dec) at full width
# and depth, 4e's shape; checks (a) at full width, Zamba2 at 12 layers (two
# calls of the shared block), Whisper at 2 + 2 layers over all 1,500 frames;
# the profiles cover PROFILED_STEPS cached decode steps after a prefill
HYBRID_ARCHS = ("zamba2-7b", "whisper-large-v3")
HYBRID_CHECKS = (("zamba2-7b", 12), ("whisper-large-v3", 2))
HYBRID_REPEATS = 3
PROFILED_STEPS = 4
# phase 4g: Qwen1.5-0.5B trained at full width and depth through the
# launcher's setup, at its defaults (batch 8 × seq 256), 20 steps, steps
# 3–20 timed; check (a) at full width cut to 2 layers, batch 2 × 64;
# check (b) on the reduced config of each family
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_TIMED_FROM = 8, 256, 20, 2
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SHAPE = 2, (2, 64)
TRAIN_FAMILIES = ("qwen1.5-0.5b", "qwen2-vl-2b", "olmoe-1b-7b",
                  "deepseek-v2-236b", "mamba2-130m", "zamba2-7b",
                  "whisper-large-v3")
TRAIN_F32_REL, TRAIN_LOSS_REL = 1e-4, 1e-5    # the CPU tests' tolerances
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores (data sheet)
# phase 4h: (a) 4g's model, shape and steps through the compressed step on a
# (1, 1) mesh over an NCCL group of one rank, then 10 plain steps on it;
# (b) DIST_RANKS processes on the one card over gloo: 3 steps of each
# compressed exchange at the reduced config (float32 compute) against the
# same ranks on the CPU, the pipeline at the reference test's shapes, the
# sharded plain step on a (2, 2) mesh against one rank; a parameter element
# farther than DIST_FAR from the CPU's has had its vote turned, which at
# most one, or 0.1 %, of a leaf's elements may have
DIST_RANKS, DIST_STEPS, DIST_LR, DIST_PLAIN_STEPS = 4, 3, 1e-3, 10
DIST_FAR = 1e-5
DIST_EXCHANGES = {"packed": ("packed", False), "psum": ("psum", False),
                  "two_phase": ("packed", True)}
PIPE_CASES = {"forward": (6, 8, 16, False), "grad": (4, 4, 8, True)}
# kernel → largest |kernel − plain version| seen in phases 2, 3 and 2b
MAX_ABS_ERR: dict[str, int] = {}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _equal(got, want, what: str, kernel: str | None = None) -> None:
    _check(got.shape == want.shape, f"{what}: shapes {tuple(got.shape)} "
           f"and {tuple(want.shape)} differ")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if kernel is not None:
        MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0), err)
    _check(err == 0, f"{what}: kernel and plain version disagree by {err}")


# -- phase 1 -----------------------------------------------------------------

def build_kernels() -> float:
    from repro_torch import telemetry
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"kernel library {name}: {path.relative_to(ROOT)}")
    print(f"build: {seconds:.2f} s, {telemetry.counter('kernels.builds')} "
          f"libraries built in {telemetry.counter('kernels.build_ns') / 1e9:.2f} s")
    return seconds


# -- phase 2 -----------------------------------------------------------------

def check_transpose(device, lanes: int) -> None:
    import torch
    g = torch.Generator(device=device).manual_seed(SEED)
    for e in (lanes, 32 * 32_769):            # the second: ragged groups
        values = torch.randint(-2**31, 2**31, (e,), dtype=torch.int32,
                               device=device, generator=g)
        check_transpose_values(values)
    for groups in SMALL_GROUPS:
        values = torch.randint(-2**31, 2**31, (32 * groups,),
                               dtype=torch.int32, device=device, generator=g)
        check_transpose_values(values, range(1, 33))
    print(f"phase 2: transposition kernels == plain versions "
          f"(n_bits {'/'.join(map(str, TRANSPOSE_BITS))}, signed/unsigned, "
          f"{lanes} lanes and 32,769 groups; n_bits 1-32 at "
          f"{' and '.join(map(str, SMALL_GROUPS))} groups)")


def check_transpose_values(values, widths=TRANSPOSE_BITS) -> None:
    from repro_torch.kernels.bitplane_transpose import (
        from_planes, from_planes_plain, to_planes, to_planes_plain)
    for n_bits in widths:
        planes = to_planes(values, n_bits)
        _equal(planes, to_planes_plain(values, n_bits), f"to_planes/{n_bits}b",
               "bitplane_to_planes")
        for signed in (False, True):
            back = from_planes(planes, signed=signed)
            _equal(back, from_planes_plain(planes, signed),
                   f"from_planes/{n_bits}b signed={signed}",
                   "bitplane_from_planes")
            # the round trip keeps the low n_bits (sign-extended if signed)
            s = 32 - n_bits
            want = (values << s) >> s if signed else \
                (values & ((1 << n_bits) - 1) if n_bits < 32 else values)
            _equal(back, want, f"round trip/{n_bits}b signed={signed}")


# -- phase 3 -----------------------------------------------------------------

def fsm_cases(full: bool = True) -> list:
    """(label, trace) pairs phase 3 runs the FSM kernel on."""
    from repro_torch.core.circuits import list_operations
    from repro_torch.core.trace import compile_chain_trace, compile_trace
    cases = [(f"{op}/8b", compile_trace(op, 8)[1]) for op in list_operations()]
    if full:
        cases += [(f"{op}/32b", compile_trace(op, 32)[1])
                  for op in ("addition", "multiplication", "division")]
    chain = (("multiplication", ("a", "b"), "t"), ("addition", ("t", "c"), "u"),
             ("relu", ("u",), "v"))
    cases.append(("chain relu(add(mul))/8b",
                  compile_chain_trace(chain, 8, outputs=("v",))[1]))
    return cases


def random_rows(trace, banks: int, words: int, device, seed: int):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (banks, trace.n_rows, words),
                         dtype=torch.int32, device=device, generator=g)


def check_fsm(device, banks: int, words: int, full: bool = True) -> None:
    import torch

    from repro_torch.kernels.uprog_executor import (uprog_execute,
                                                    uprog_execute_plain)
    for k, (label, trace) in enumerate(fsm_cases(full)):
        cmds = torch.as_tensor(trace.cmds, dtype=torch.int32, device=device)
        rows = random_rows(trace, banks, words, device, SEED + k)
        _equal(uprog_execute(cmds, rows), uprog_execute_plain(cmds, rows),
               f"uprog_execute {label}", "uprog_execute")
        print(f"phase 3: FSM kernel == plain on {label} "
              f"(R={trace.n_rows}, N={trace.n_commands}, "
              f"steps={len(trace.cmds)}, {banks}x{words} words)")
    for n_rows, n_cmds in ALIASED_STREAMS:
        cmds = torch.as_tensor(aliased_stream(n_rows, n_cmds, SEED + n_rows),
                               device=device)
        rows = torch.randint(-2**31, 2**31, (3, n_rows, 97),
                             dtype=torch.int32, device=device,
                             generator=torch.Generator(device=device)
                             .manual_seed(SEED + n_rows))
        _equal(uprog_execute(cmds, rows), uprog_execute_plain(cmds, rows),
               f"uprog_execute aliased R={n_rows}", "uprog_execute")
        print(f"phase 3: FSM kernel == plain on an aliased stream "
              f"(R={n_rows}, steps={n_cmds}, 3x97 words)")


def check_uprogram_entry(device, banks: int, words: int) -> None:
    """The μProgram-level entry ``run_uprogram_kernel`` on the card (the FSM
    kernel) against the same call on the CPU (its plain version), exactly,
    on seeded banked planes of every bit pattern."""
    import torch

    from repro_torch.core.trace import compile_trace
    from repro_torch.kernels.ops import run_uprogram_kernel
    for k, (op, (inputs, out_bits)) in enumerate(UPROGRAM_CASES.items()):
        prog = compile_trace(op, 8)[0]
        g = torch.Generator().manual_seed(SEED + 50 + k)
        operands = {name: torch.randint(-2**31, 2**31, (banks, n, words),
                                        dtype=torch.int32, generator=g)
                    for name, n in inputs.items()}
        want = run_uprogram_kernel(prog, operands, out_bits)
        got = run_uprogram_kernel(
            prog, {name: t.to(device) for name, t in operands.items()},
            out_bits)
        _check(sorted(got) == sorted(want), f"run_uprogram_kernel {op}: "
               f"outputs {sorted(got)}")
        for name, planes in want.items():
            _check(got[name].device.type == torch.device(device).type,
                   f"run_uprogram_kernel {op}: {name} left the card")
            _equal(got[name].cpu(), planes,
                   f"run_uprogram_kernel {op}/8b {name}", "uprog_execute")
        print(f"phase 3: run_uprogram_kernel({op}/8b) on the card == the "
              f"CPU run ({banks}x{words} words, out planes "
              f"{tuple(want['out'].shape)})")


def aliased_stream(n_rows: int, n_cmds: int, seed: int):
    """A seeded int32[n_cmds, 4] stream whose ports alias: MAJ with a == b,
    MAJ with a == -c, COPY onto its own source (plain or complemented),
    beside MAJ and COPY on independent random ports."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(1, n_rows + 1, n_cmds)
               * rng.choice((-1, 1), n_cmds) for _ in range(3))
    kind = rng.integers(0, 5, n_cmds)
    op = np.isin(kind, (0, 1, 3)).astype(np.int64)
    b = np.where(kind == 0, a, np.where(kind == 2, a * rng.choice((-1, 1),
                                                                 n_cmds), b))
    c = np.where(kind == 1, -a, np.where(op == 0, b, c))
    return np.stack([op, a, b, c], axis=1).astype(np.int32)


# -- phase 2b ----------------------------------------------------------------

def packed_words(device, rows: int, kw: int, seed: int):
    """Random sign-packed words (every bit pattern, bit 31 included)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31, (rows, kw), dtype=torch.int32,
                         device=device, generator=g)


def check_bitserial(device) -> None:
    import torch

    from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                      bitserial_matmul_plain)
    for i, (label, m, n, k) in enumerate(XNOR_SHAPES):
        a = packed_words(device, m, k // 32, SEED + 100 + 2 * i)
        b = packed_words(device, n, k // 32, SEED + 101 + 2 * i)
        # bk=1: the reference's TPU K block must divide Kw (33 at k_tail);
        # the CUDA kernel tiles K its own way
        got = bitserial_matmul(a, b, k, bk=1)
        _equal(got, bitserial_matmul_plain(a, b, k),
               f"bitserial_matmul {label}", "bitserial_matmul")
        if label == "fc6":
            _check(torch.equal(bitserial_matmul(a, b, k, bk=1), got),
                   "bitserial_matmul fc6: a second run differs")
        print(f"phase 2b: XNOR-popcount kernel == plain on {label} "
              f"(M={m} N={n} K={k})")


# -- phase 4 -----------------------------------------------------------------

def main_path(device, banks: int, lanes: int) -> dict:
    """The quickstart flow on the port, every value checked against numpy.
    Returns the machine's report and timings."""
    import numpy as np
    import torch

    from repro_torch.core.graph import lit_not
    from repro_torch.core.uprogram import DRow
    from repro_torch.ops import (SimdramMachine, bbop_add, bbop_greater,
                                 bbop_if_else, bbop_mul, bbop_relu, bbop_sub)
    from repro_torch.simdram.layout import (reset_transpose_stats,
                                            transpose_counts)
    from repro_torch.simdram.timing import DRAMTiming

    def host(t):
        return t.cpu().numpy().astype(np.int64)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    machine = SimdramMachine(timing=DRAMTiming(), banks=banks, mode="replay",
                             device=device)
    _check(machine.backend is None, "machine must run the default backend")
    shape = (banks, lanes)
    x, y = rng.integers(0, 256, shape), rng.integers(0, 256, shape)

    # Step 3 through a bound op
    out = machine.op("addition")(x, y, n_bits=8)
    _check(out.device.type == torch.device(device).type,
           "result left the machine's device")
    _check(np.array_equal(host(out), (x + y) & 255), "op('addition')")

    # paper Listing 1: predicated add/sub through the bbop ISA
    a, b = rng.integers(0, 128, shape), rng.integers(0, 128, shape)
    pred = rng.integers(0, 128, shape)
    with machine.session():
        d = bbop_add(a, b, 8)
        e = bbop_sub(a, b, 8)
        f = bbop_greater(a, pred, 8)
        c = bbop_if_else(f, d, e, 8)
    _check(np.array_equal(host(c), np.where(a > pred, (a + b) & 255,
                                            (a - b) & 255)),
           "Listing-1 predicated add/sub")

    # user-defined operation: Steps 1-3 as API
    def build_gated_sub(g):
        av, bv, gate, w = (g.input(n) for n in ("a", "b", "gate", "borrow"))
        bg = g.gate_and(bv, gate)
        axb = g.gate_xor(av, bg)
        g.add_output("out", g.gate_xor(axb, w))
        g.add_output("borrow", g.gate_or_node(
            g.gate_and(lit_not(av), bg), g.gate_and(w, lit_not(axb))))

    gated_sub = machine.define_op(
        "gated_sub", build_gated_sub,
        invariants={"gate": DRow("gate", 0, fixed=True)},
        states={"borrow": 0})
    gmask = rng.integers(0, 2, shape)
    with machine.timed(mode="replay") as st:
        got = gated_sub(x, y, gmask, n_bits=8)
    _check(np.array_equal(host(got), np.where(gmask, (x - y) & 255, x)),
           "define_op('gated_sub')")
    _check(st.replay_ns >= st.exec_ns > 0, "gated_sub replay timing")

    # plane-resident pipeline: relu(add(mul)), unfused and fused
    av, bv, cv = (rng.integers(0, 256, shape) for _ in range(3))
    raw = (av * bv + cv) & 255
    want = np.where(raw >> 7, 0, raw)
    for fused in (False, True):
        reset_transpose_stats()
        with machine.pipeline(timed=True, fused_trace=fused) as p:
            pa, pb, pc = p.load([av, bv, cv], 8)
            res = p.store(bbop_relu(bbop_add(bbop_mul(pa, pb, 8), pc, 8), 8))
        _check(np.array_equal(host(res), want),
               f"pipeline relu(add(mul)) fused={fused}")
        _check(transpose_counts() == (1, 1),
               f"pipeline transposition passes {transpose_counts()}")

    # two tenants, one bank-stacked request each: submit / drain(batch=True)
    ops_a = [(rng.integers(0, 256, lanes), rng.integers(0, 256, lanes))
             for _ in range(banks)]
    ops_b = [(rng.integers(0, 16, lanes), rng.integers(0, 16, lanes))
             for _ in range(banks)]
    meters = ("exec_ns", "exec_nj", "replay_ns", "elem_ops")
    before = {m: getattr(machine.stats, m) for m in meters}
    futs = [machine.submit("addition", p, q, tenant="A") for p, q in ops_a]
    futs += [machine.submit("multiplication", p, q, tenant="B")
             for p, q in ops_b]
    sched = machine.drain(batch=True)
    _check(sched.n_requests == 2, f"batched drain issued {sched.n_requests} "
           "requests, expected one per tenant")
    for fut, (p, q) in zip(futs, ops_a + ops_b):
        want = (p + q) & 255 if fut.name == "addition" else (p * q) & 255
        _check(np.array_equal(host(fut.result()), want),
               f"drained {fut.name} for tenant {fut.tenant}")
    tenants = machine.stats.tenants
    _check(set(tenants) == {"A", "B"}, f"tenants {sorted(tenants)}")
    for meter in meters:        # the drain's share of the machine meters
        total = sum(getattr(t, meter) for t in tenants.values())
        drained = getattr(machine.stats, meter) - before[meter]
        _check(total > 0 and abs(total - drained) <= 1e-9 * total,
               f"tenant {meter} {total} does not sum to the drain's {drained}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"report": machine.perf_report(), "seconds": seconds,
            "makespan_ns": sched.ns}


# -- phase 4b ----------------------------------------------------------------

def apps_inputs() -> dict:
    """The applications path's inputs and their numpy answers (made once,
    outside the timed passes)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    img = rng.integers(0, 256, APP_IMAGE)
    codes = rng.integers(0, 256, APP_CODES)
    layers = []
    for label, m, n, k in XNOR_SHAPES[:2]:
        x, w = ((rng.integers(0, 2, (r, k), dtype=np.int8) * 2 - 1)
                .astype(np.float32) for r in (m, n))
        # exact in float32: every partial sum is an integer below 2**24
        layers.append((label, x, w, (x @ w.T).astype(np.int32)))
    return {"img": img, "codes": codes, "layers": layers,
            "bright": np.minimum(img + 64, 255),
            "count": int(((codes >= 50) & (codes <= 180)).sum()),
            "dark": np.where(img > 128, (img - 40) & 255, img)}


def apps_path(device, backend: str | None, inp: dict) -> dict:
    """The applications on a fresh 16-bank machine, every result checked
    against numpy.  Returns the host wall time and the cache counters."""
    import numpy as np
    import torch

    from repro_torch.apps import make_apps
    t0 = time.perf_counter()
    apps = make_apps(device, banks=BANKS, lanes=LANES, backend=backend)
    bright = apps.brightness(inp["img"], 64)
    count = apps.bitweaving_scan(inp["codes"], 50, 180)
    dark = apps.masked_darken(inp["img"], inp["img"] > 128, 40)
    layers = [(label, apps.xnor_layer(x, w), want)
              for label, x, w, want in inp["layers"]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check(np.array_equal(bright, inp["bright"]), "brightness")
    _check(count == inp["count"], f"bitweaving scan {count} != {inp['count']}")
    _check(np.array_equal(dark, inp["dark"]), "masked darken")
    for label, got, want in layers:
        _check(np.array_equal(got, want), f"xnor layer {label}")
    return {"seconds": seconds, "cache": apps.machine.cache_stats()}


# -- phase 4c ----------------------------------------------------------------

def serving_run(device) -> tuple:
    """32 users x 16 tokens through ``SimdramServer`` on ``device``.
    Returns (server, handles, stats, host seconds)."""
    import torch

    from repro_torch.serve import SimdramServer
    t0 = time.perf_counter()
    server = SimdramServer(n_machines=2, n_banks=BANKS, device=device,
                           mode="replay")
    handles = [server.submit_session(SERVE_MIX[u % len(SERVE_MIX)],
                                     n_tokens=SERVE_TOKENS,
                                     arrival_ns=u * SERVE_GAP_NS, seed=u)
               for u in range(SERVE_USERS)]
    stats = server.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return server, handles, stats, time.perf_counter() - t0


def serving_oracle(profile, n_tokens: int, seed: int):
    """A session's final value, replayed in numpy from its seeded state."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hi = 1 << profile.n_bits
    a = rng.integers(0, hi, profile.lanes, dtype=np.int64)
    b = rng.integers(1, hi, profile.lanes, dtype=np.int64)
    step = {"addition": np.add, "multiplication": np.multiply,
            "subtraction": np.subtract, "maximum": np.maximum,
            "minimum": np.minimum}[profile.op]
    for _ in range(n_tokens):
        a = step(a, b) & (hi - 1)
    return a


def serving_path(device) -> dict:
    """Phase 4c's run on the card, checked against numpy and against the
    same run on the CPU."""
    import numpy as np

    server, handles, stats, seconds = serving_run(device)
    _check(all(h.done() for h in handles), "a serving session did not retire")
    for u, h in enumerate(handles):
        got = h.result()
        _check(got.device.type == "cuda", "a session's state left the card")
        want = serving_oracle(h.session.profile, SERVE_TOKENS, u)
        _check(np.array_equal(got.cpu().numpy(), want),
               f"session {u} ({h.session.profile.config}) != numpy replay")
    snap = stats.snapshot()
    _check(snap["n_sessions"] == SERVE_USERS
           and snap["total_tokens"] == SERVE_USERS * SERVE_TOKENS,
           f"served {snap['n_sessions']} sessions, "
           f"{snap['total_tokens']} tokens")
    _, cpu_handles, cpu_stats, cpu_seconds = serving_run("cpu")
    _check(cpu_stats.snapshot() == snap,
           "ServingStats snapshot differs from the CPU run's")
    _check(all(np.array_equal(h.result().cpu().numpy(),
                              c.result().numpy())
               for h, c in zip(handles, cpu_handles)),
           "session values differ from the CPU run's")
    return {"seconds": seconds, "cpu_seconds": cpu_seconds,
            "report": stats.report(), "snapshot": snap}


# -- phase 4d ----------------------------------------------------------------

def sampler_logits():
    """Seeded float32 logits of a decode batch, a few entries masked."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    logits = rng.standard_normal(SAMPLER_SHAPE, dtype=np.float32)
    rows = rng.integers(0, SAMPLER_SHAPE[0], 64)
    cols = rng.integers(0, SAMPLER_SHAPE[1], 64)
    logits[rows, cols] = -np.inf
    return logits


def sampler_call(machine, logits) -> tuple:
    """One ``simdram_greedy_token`` call on ``machine`` under a fresh
    ``PerfStats``: (token ids, PerfStats, host seconds)."""
    import torch

    from repro_torch.ops import PerfStats
    from repro_torch.serve.decode import simdram_greedy_token
    x = torch.as_tensor(logits, device=machine.device)
    st = PerfStats()
    t0 = time.perf_counter()
    tok = simdram_greedy_token(x, machine=machine, perf_stats=st)
    if machine.device.type == "cuda":
        torch.cuda.synchronize()
    return tok, st, time.perf_counter() - t0


def sampler_path(device, logits) -> dict:
    """Phase 4d: one call on a fresh machine on the card, checked against
    the same call on the CPU.  Returns the machine (warm now) and the
    host seconds."""
    import torch

    from repro_torch.ops import SimdramMachine
    from repro_torch.serve.decode import quantize_logits
    machine = SimdramMachine(device=device)
    tok, st, cold = sampler_call(machine, logits)
    cpu_tok, cpu_st, cpu_seconds = sampler_call(
        SimdramMachine(device="cpu"), logits)
    _check(tok.device.type == "cuda" and tok.shape == (SAMPLER_SHAPE[0],),
           f"token ids {tuple(tok.shape)} on {tok.device}")
    _check(torch.equal(tok.cpu(), cpu_tok), "token ids differ from the CPU's")
    q = quantize_logits(torch.as_tensor(logits, device=device))
    cpu_q = quantize_logits(torch.as_tensor(logits))
    _check(torch.equal(q.cpu(), cpu_q),
           "quantized logits differ from the CPU's")
    rows = torch.arange(SAMPLER_SHAPE[0], device=device)
    _check(torch.equal(q[rows, tok.long()], q.amax(-1)),
           "a token id is not a maximal quantized logit")
    _check(st.n_programs == 54 and st.n_transposes == 3,
           f"{st.n_programs} μPrograms and {st.n_transposes} transposition "
           "passes a call, expected 54 and 3")
    _check(st.snapshot() == cpu_st.snapshot(),
           "PerfStats snapshot differs from the CPU run's")
    return {"machine": machine, "cold_seconds": cold,
            "cpu_seconds": cpu_seconds, "exec_ns": st.exec_ns,
            "total_ns": st.total_ns}

# -- phase 4e ----------------------------------------------------------------

def lm_model(cfg, device, seed: int):
    """The port's Transformer for ``cfg`` on ``device``, its parameters drawn
    in place from a seeded generator on ``device`` (one copy of the
    parameters on the card, never the stacked tree beside the module)."""
    import torch

    from repro_torch.models.transformer import Transformer
    gen = torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, device=device).draw_params(gen)


def lm_tokens(cfg, shape: tuple, seed: int, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                           device=device)


def lm_extra(cfg, b: int, seed: int, device, dtype) -> dict:
    """``greedy_decode``'s ``extra_batch`` for ``cfg``: an enc-dec model's
    encoder frames (b, encoder_seq, d_model), drawn on ``device`` from a
    seeded generator (the conv frontend is a stub in both packages); empty
    for every other family."""
    import torch
    if not cfg.enc_dec:
        return {}
    g = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=device) * 0.1
    return {"encoder_frames": frames.to(dtype)}


def decode_matches_prefill(device, arch: str, n_layers: int | None,
                           seed: int) -> float:
    """Check (a): at full width in float32 compute (``n_layers`` layers, or
    the full depth with None), the logits of ``LM_CHECK_STEPS`` one-token
    cached steps of 2 sequences equal a no-cache forward within 2e-3 (the
    CPU tests' bound), TF32 off.  An MoE runs at capacity factor
    ceil(E / k) (8.0 for OLMoE), where no group drops a token, so one-token
    groups route as the whole sequence does.  A layer pattern is cut with
    the depth; an enc-dec model keeps ``n_layers`` encoder layers too and
    all its frames, drawn from the seed: they join the no-cache forward and
    every cached step, whose caches ``prime_encdec_caches`` primes first,
    as ``greedy_decode`` does.  Returns the largest difference."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (init_caches,
                                                prime_encdec_caches)
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 matmul is on; the float32 checks need it off")
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if n_layers is not None:
        cut = {"n_layers": n_layers}
        if cfg.layer_pattern:
            cut["layer_pattern"] = cfg.layer_pattern[:n_layers]
        if cfg.enc_dec:
            cut["n_encoder_layers"] = n_layers
        cfg = dataclasses.replace(cfg, **cut)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            math.ceil(cfg.n_experts / cfg.experts_per_tok)))
    model = lm_model(cfg, device, seed)
    b, s = 2, LM_CHECK_STEPS
    toks = lm_tokens(cfg, (b, s), seed + 1, device)
    extra = lm_extra(cfg, b, seed + 2, device, torch.float32)
    with torch.no_grad():
        full = model({"tokens": toks, **extra})[0]
    caches = init_caches(cfg, b, s, dtype=torch.float32, device=device)
    if extra:
        caches = prime_encdec_caches(model, cfg, extra, caches)
    outs = []
    for t in range(s):
        logits, _, caches = model({"tokens": toks[:, t:t + 1], **extra},
                                  caches)
        outs.append(logits)
    err = float((torch.cat(outs, 1) - full).abs().max())
    _check(err < LM_SELF_ABS, f"{cfg.name}: cached decode differs from the "
           f"no-cache forward by {err} at full width (limit {LM_SELF_ABS})")
    del model, caches
    torch.cuda.empty_cache()
    return err


def lm_generate(model, cfg, prompt, sampler: str, machine=None,
                perf=None, extra=None) -> tuple:
    """One ``greedy_decode`` call (``extra`` its ``extra_batch``): (token
    ids, host seconds, prefill ms, ms a decoded token).  CUDA events at the
    start and end of every forward split the same run on the card's clock:
    the prefill is the first forward; each of the ``LM_NEW − 1`` later
    tokens is one cached step forward and its pick (from the start of the
    first step forward to the end of the last pick).  The first token's
    pick and the cache allocation (and an enc-dec model's priming of the
    caches) are in neither figure."""
    import torch

    from repro_torch.serve.decode import greedy_decode
    marks = []

    def mark(*_):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    hooks = [model.register_forward_pre_hook(mark),
             model.register_forward_hook(mark)]
    try:
        t0 = time.perf_counter()
        out = greedy_decode(model, cfg, prompt, steps=LM_NEW,
                            max_seq=LM_PROMPT + LM_NEW, sampler=sampler,
                            sampler_perf=perf, machine=machine,
                            extra_batch=extra)
        mark()
        _sync(prompt.device)
        seconds = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    _check(len(marks) == 2 * LM_NEW + 1,
           f"{len(marks) - 1} forward marks for {LM_NEW} forwards")
    return (out, seconds, marks[0].elapsed_time(marks[1]),
            marks[2].elapsed_time(marks[-1]) / (LM_NEW - 1))


def lm_gate_input(model, cfg, prompt):
    """Layer 0's MLP input during a prefill of ``prompt``: the pum gate's
    activation operand, 2,048 × 1,024."""
    import torch

    from repro_torch.models.transformer import init_caches
    from repro_torch.serve.decode import make_prefill
    seen = []
    hook = model.blocks[0].ffn.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    try:
        with torch.no_grad():
            caches = init_caches(cfg, LM_BATCH, LM_PROMPT + LM_NEW,
                                 device=prompt.device)
            make_prefill(cfg)(model, {"tokens": prompt}, caches)
    finally:
        hook.remove()
    return seen[0].reshape(-1, cfg.d_model)


def lm_replay_checks(model, cfg, prompt, tokens, unrolled,
                     extra=None) -> None:
    """Checks (b) and (c): the decode replayed step by step on the same
    tokens (``extra`` joining every forward, enc-dec caches primed first,
    as in ``greedy_decode``); each token the in-DRAM sampler picked is a
    maximal index of that step's quantized logits, and equals the pick of
    the ``unrolled`` backend (eager torch, no FSM kernel) on the same
    logits."""
    import torch

    from repro_torch.models.transformer import (init_caches,
                                                prime_encdec_caches)
    from repro_torch.serve.decode import (make_prefill, make_serve_step,
                                          quantize_logits,
                                          simdram_greedy_token)
    rows = torch.arange(LM_BATCH, device=prompt.device)
    with torch.no_grad():
        caches = init_caches(cfg, LM_BATCH, LM_PROMPT + LM_NEW,
                             device=prompt.device)
        extra = extra or {}
        if extra:
            caches = prime_encdec_caches(model, cfg, extra, caches)
        logits, caches = make_prefill(cfg)(model, {"tokens": prompt, **extra},
                                           caches)
        step = make_serve_step(cfg)
        for t in range(LM_NEW):
            last = logits[:, -1]
            q = quantize_logits(last)
            tok = tokens[:, t]
            _check(torch.equal(q[rows, tok], q.amax(-1)),
                   f"step {t}: a sampled token is not a maximal quantized "
                   "logit")
            other = simdram_greedy_token(last, machine=unrolled)
            _check(torch.equal(other.long(), tok),
                   f"step {t}: the unrolled backend picks other tokens")
            if t + 1 < LM_NEW:
                logits, caches = step(model, caches,
                                      {"tokens": tokens[:, t:t + 1], **extra})


def lm_serve(model, cfg, prompt, wrappers: dict, repeats: int,
             device, extra=None) -> dict:
    """The serving runs of phases 4e, 4f and 4i on ``model`` (``extra`` the
    decodes' ``extra_batch``): a cold decode with each sampler (the
    in-DRAM one with every launch counter set to 0 before it, and a
    ``PerfStats``), ``repeats`` warm decodes of both in turns, then checks
    (b) and (c).  A token must launch the FSM kernel once a μProgram and
    the transposition kernels 3 times.  Returns the tokens, launch counts,
    ``PerfStats`` and timings."""
    import torch

    from repro_torch.ops import PerfStats, SimdramMachine
    res = {}
    res["host_tokens"], res["host_cold_s"] = lm_generate(
        model, cfg, prompt, "host", extra=extra)[:2]
    machine = SimdramMachine(device=device, banks=LM_BATCH)
    perf = PerfStats()
    for w in wrappers.values():
        w.launches = 0
    tokens, res["simdram_cold_s"] = lm_generate(
        model, cfg, prompt, "simdram", machine, perf, extra)[:2]
    res["launches"] = {name: w.launches for name, w in wrappers.items()}
    _check(tokens.shape == (LM_BATCH, LM_NEW)
           and tokens.device.type == torch.device(device).type
           and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
           f"sampled token ids {tuple(tokens.shape)} on {tokens.device}")
    # a (greater, if_else, if_else) triple per halving round and SWAR
    # stride: 3 · log2(lanes) μPrograms a token
    programs = 3 * (1 << (cfg.vocab - 1).bit_length()).bit_length() - 3
    _check(perf.n_programs == programs * LM_NEW
           and perf.n_transposes == 3 * LM_NEW,
           f"{perf.n_programs} μPrograms and {perf.n_transposes} "
           f"transposition passes for {LM_NEW} tokens, expected {programs} "
           "and 3 a token")
    k1 = res["launches"]["uprog_execute"]
    k2 = (res["launches"]["bitplane_to_planes"]
          + res["launches"]["bitplane_from_planes"])
    _check(k1 == programs * LM_NEW and k2 == 3 * LM_NEW,
           f"{k1} FSM and {k2} transposition launches for {LM_NEW} tokens, "
           f"expected {programs} and 3 a token")
    res["perf"] = perf
    # warm runs of both samplers in turns (the host's speed drifts)
    # (host seconds, prefill ms, ms a decoded token) per run
    res["host_runs"], res["simdram_runs"] = [], []
    for _ in range(repeats):
        res["host_runs"].append(lm_generate(model, cfg, prompt, "host",
                                            extra=extra)[1:])
        again, *run = lm_generate(model, cfg, prompt, "simdram", machine,
                                  extra=extra)
        res["simdram_runs"].append(run)
        _check(torch.equal(again, tokens), "a second simdram decode picked "
               "other tokens")
    res["agree"] = float((tokens == res["host_tokens"]).float().mean())
    lm_replay_checks(model, cfg, prompt, tokens,
                     SimdramMachine(device=device, banks=LM_BATCH,
                                    backend="unrolled"), extra)
    res["machine"] = machine
    return res


def print_lm_serve(phase: str, lm: dict, cfg) -> None:
    """Print the timings, launches and modeled sampler cost of
    :func:`lm_serve`'s runs."""
    perf, launches = lm["perf"], lm["launches"]
    for name in ("host", "simdram"):
        runs = lm[f"{name}_runs"]
        mid = [sorted(col)[len(col) // 2] for col in zip(*runs)]
        print(f"phase {phase}: greedy_decode, {name} sampler, {len(runs)} "
              f"warm runs (cold {lm[f'{name}_cold_s']:.4f} s): "
              f"{' '.join(f'{r[0]:.4f}' for r in runs)} s of host wall time; "
              f"prefill {' '.join(f'{r[1]:.3f}' for r in runs)} ms; "
              f"{' '.join(f'{r[2]:.3f}' for r in runs)} ms a decoded token "
              f"(one cached step forward and its pick, tokens 2-{LM_NEW}, "
              f"CUDA events in the same run); medians {mid[1]:.3f} ms "
              f"prefill, {mid[2]:.3f} ms a token")
    per_token = {name: n / LM_NEW for name, n in launches.items()}
    print(f"phase {phase}: launches of the simdram run {launches}, a token "
          f"{per_token}")
    print(f"phase {phase}: sampler modeled {perf.total_ns / LM_NEW:.1f} ns "
          f"and {perf.total_nj / LM_NEW:.1f} nJ of DRAM a token "
          f"({perf.n_programs // LM_NEW} μPrograms, "
          f"{perf.n_transposes // LM_NEW} transposition passes, "
          f"{perf.max_banks} banks)")
    print(f"phase {phase} (b, c): every sampled token is a maximal quantized "
          f"logit and equals the unrolled backend's pick; ids equal the "
          f"host sampler's on {100 * lm['agree']:.2f}% of tokens")


def reduced_inputs(cfg, b: int, s: int, seed: int) -> dict:
    """Seeded tokens (and, enc-dec, encoder frames) on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.enc_dec:
        batch["encoder_frames"] = torch.as_tensor(
            rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)) * 0.1,
            dtype=torch.float32)
    return batch


def moe_routes(model, cfg, x):
    """Layer 0's top-k expert sets of the FFN input ``x`` (sorted)."""
    import torch
    with torch.no_grad():
        idx = model.blocks[0].ffn.route(x.reshape(1, -1, cfg.d_model))[2]
    return idx.sort(-1).values.cpu()


def reduced_matches_cpu(device, arch: str) -> tuple:
    """Check (d): ``arch``'s reduced config (bf16 compute) on the card and on
    the CPU with the same parameters, without and through the caches
    (whisper's primed from its encoder frames by ``prime_encdec_caches``,
    as ``greedy_decode``'s ``extra_batch`` primes them): logits within
    5e-2 × max|CPU logit|, greedy ids equal wherever the CPU's top-2 gap
    exceeds that.  An MoE's layer-0 routes of the CPU's FFN input are
    compared first, on both devices.  Whisper also decodes 4 tokens
    through ``greedy_decode(extra_batch=...)`` on both; its first token
    must agree where the primed logits' gap is clear.  Returns (largest
    error, tolerance)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.transformer import (Transformer, init_caches,
                                                model_defs,
                                                prime_encdec_caches)
    from repro_torch.serve.decode import greedy_decode
    cfg = get_reduced(arch)
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(SEED),
                         device="cpu")
    batch = reduced_inputs(cfg, 4, 12, SEED + 9)
    models = {dev: Transformer(cfg, device=dev).load_params(
        tree_map(lambda t, d=dev: t.to(d), params)) for dev in ("cpu", device)}
    if cfg.moe:
        seen = []
        hook = models["cpu"].blocks[0].ffn.register_forward_hook(
            lambda mod, args, out: seen.append(args[0]))
        with torch.no_grad():
            models["cpu"](batch)
        hook.remove()
        want = moe_routes(models["cpu"], cfg, seen[0])
        got = moe_routes(models[device], cfg, seen[0].to(device))
        _check(torch.equal(got, want), f"reduced {arch}: MoE routes on the "
               f"card differ from the CPU's on {int((got != want).any(-1).sum())}"
               " tokens")
    worst = (0.0, 0.0)
    for cached in (False, True):
        out = {}
        for dev, model in models.items():
            b = tree_map(lambda t, d=dev: t.to(d), batch)
            caches = None
            if cached:
                caches = init_caches(cfg, 4, 16, device=dev)
                if cfg.enc_dec:
                    caches = prime_encdec_caches(
                        model, cfg, {"encoder_frames": b["encoder_frames"]},
                        caches)
            with torch.no_grad():
                logits = model(b, caches)[0]
            _check(logits.device.type == torch.device(dev).type,
                   f"logits on {logits.device}, expected {dev}")
            out[dev] = logits.cpu()
        want, got = out["cpu"], out[device]
        tol = LM_BF16_REL * float(want.abs().max())
        err = float((got - want).abs().max())
        _check(err <= tol, f"reduced {arch} on the card differs from the "
               f"CPU by {err} (limit {tol}, cached={cached})")
        top2 = want.topk(2, -1).values
        clear = (top2[..., 0] - top2[..., 1]) > tol
        _check(bool(clear.any()) and torch.equal(
            got.argmax(-1)[clear], want.argmax(-1)[clear]),
            f"{arch}: greedy ids on the card differ from the CPU's "
            f"(cached={cached})")
        worst = max(worst, (err, tol))
    if cfg.enc_dec:
        ids = {dev: greedy_decode(
            model, cfg, batch["tokens"].to(dev), steps=4,
            extra_batch={"encoder_frames": batch["encoder_frames"].to(dev)}
            ).cpu() for dev, model in models.items()}
        first = clear[:, -1]
        _check(torch.equal(ids[device][first, 0], ids["cpu"][first, 0])
               and torch.equal(ids["cpu"][:, 0], want[:, -1].argmax(-1)),
               f"{arch}: greedy_decode with extra_batch picks another first "
               "token on the card")
    return worst


def lm_pum_gate_check(x, w_gate) -> None:
    """Check (e): K3 on ``pack_signs`` of the pum gate operands equals the
    einsum of their signs, exactly."""
    import torch

    from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                      pack_signs)
    from repro_torch.models.layers import sign_ste
    with torch.no_grad():
        want = torch.einsum("md,df->mf", sign_ste(x.float()),
                            sign_ste(w_gate.float())).to(torch.int32)
        got = bitserial_matmul(pack_signs(x), pack_signs(w_gate.t()),
                               x.shape[1])
    _equal(got, want, f"XNOR-popcount on the pum gate operands "
           f"{tuple(x.shape)} x {tuple(w_gate.shape)}", "bitserial_matmul")


def lm_serving_path(device, wrappers: dict) -> dict:
    """Phase 4e: greedy decoding of Qwen1.5-0.5B at full width on the card,
    each token picked by the in-DRAM sampler; checks (a)–(e).  Returns the
    launch counts of the simdram run and the numbers to print."""
    from repro_torch.configs import get_config
    decode_err = decode_matches_prefill(device, LM_ARCH, LM_CHECK_LAYERS,
                                        SEED + 7)
    cfg = get_config(LM_ARCH)
    model = lm_model(cfg, device, SEED + 10)
    prompt = lm_tokens(cfg, (LM_BATCH, LM_PROMPT), SEED + 11, device)
    x = lm_gate_input(model, cfg, prompt)
    res = lm_serve(model, cfg, prompt, wrappers, LM_REPEATS, device)
    res["decode_err"] = decode_err
    res["params"] = sum(p.numel() for p in model.parameters())
    res["reduced_err"] = reduced_matches_cpu(device, LM_ARCH)
    lm_pum_gate_check(x, model.blocks[0].ffn.w_gate.detach())
    res["model"], res["cfg"], res["prompt"] = model, cfg, prompt
    return res


# -- phase 4f ----------------------------------------------------------------

def full_width_serve(device, arch: str, wrappers: dict, seed: int,
                     repeats: int) -> dict:
    """One model of phases 4f and 4i at full width and depth, drawn in
    place on the card: 16 × 32 tokens through ``greedy_decode`` with each
    sampler (checks (b), (c)), an enc-dec model's frames in
    ``extra_batch``; the peak memory after the build and through the
    decodes, and an enc-dec model's priming of the caches timed alone.
    Returns the numbers to print and what the profiled decodes need."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (init_caches,
                                                prime_encdec_caches)
    t0 = time.perf_counter()
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = lm_model(cfg, device, seed)
    _sync(device)
    res = {"build_peak": torch.cuda.max_memory_allocated(),
           "params": sum(p.numel() for p in model.parameters())}
    prompt = lm_tokens(cfg, (LM_BATCH, LM_PROMPT), seed + 1, device)
    extra = lm_extra(cfg, LM_BATCH, seed + 2, device, torch.bfloat16)
    res.update(lm_serve(model, cfg, prompt, wrappers, repeats, device, extra))
    if extra:
        caches = init_caches(cfg, LM_BATCH, LM_PROMPT + LM_NEW, device=device)
        with torch.no_grad():
            res["prime_ms"] = event_ms(
                lambda: prime_encdec_caches(model, cfg, extra, caches), 3)
        del caches
    res["serve_peak"] = torch.cuda.max_memory_allocated()
    res["model"], res["cfg"], res["prompt"], res["extra"] = (model, cfg,
                                                             prompt, extra)
    res["seconds"] = time.perf_counter() - t0
    return res


def moe_serving_path(device, wrappers: dict) -> dict:
    """Phase 4f: checks (a) for OLMoE and DeepSeek-V2 (full width, 2 layers)
    and Mamba2-130m (full width and depth); then OLMoE-1B-7B at full width
    and depth serves 16 × 32 tokens through ``greedy_decode`` with each
    sampler (checks (b), (c)); then check (d) on the reduced config of
    each new family.  Returns the numbers to print."""
    import torch
    t0 = time.perf_counter()
    res = {"decode_err": {}}
    for i, (arch, layers) in enumerate(MOE_CHECKS):
        torch.cuda.reset_peak_memory_stats()
        res["decode_err"][arch] = (decode_matches_prefill(
            device, arch, layers, SEED + 30 + 2 * i),
            torch.cuda.max_memory_allocated())
    res.update(full_width_serve(device, MOE_ARCH, wrappers, SEED + 20,
                                MOE_REPEATS))
    res["reduced_err"] = {arch: reduced_matches_cpu(device, arch)
                          for arch in REDUCED_FAMILIES}
    res["seconds"] = time.perf_counter() - t0
    return res

# -- phase 4i ----------------------------------------------------------------

def decode_steps(model, cfg, prompt, extra: dict, steps: int):
    """Prefill ``prompt`` (an enc-dec model's caches primed first) now, and
    return ``run()``, which takes ``steps`` cached one-token steps with the
    host's pick and returns their wall seconds: a profile of it sees
    decode steps only."""
    import torch

    from repro_torch.models.transformer import (init_caches,
                                                prime_encdec_caches)
    from repro_torch.serve.decode import make_prefill, make_serve_step
    with torch.no_grad():
        caches = init_caches(cfg, LM_BATCH, LM_PROMPT + steps,
                             device=prompt.device)
        if extra:
            caches = prime_encdec_caches(model, cfg, extra, caches)
        logits, caches = make_prefill(cfg)(model, {"tokens": prompt, **extra},
                                           caches)
    _sync(prompt.device)
    step = make_serve_step(cfg)

    def run() -> float:
        nonlocal logits, caches
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(steps):
                tok = logits[:, -1].argmax(-1)[:, None]
                logits, caches = step(model, caches, {"tokens": tok, **extra})
        _sync(prompt.device)
        return time.perf_counter() - t0
    return run


def hybrid_encdec_path(device, wrappers: dict, card: str) -> dict:
    """Phase 4i: checks (a) for Zamba2-7B (12 layers) and Whisper-large-v3
    (2 + 2 layers, 1,500 frames) at full width, then each model at full
    width and depth through :func:`full_width_serve`, its numbers printed
    beside the card and its decodes profiled before it is freed.  Returns
    each model's launch counts of one in-DRAM-sampler decode."""
    import torch

    from repro_torch.models.transformer import _shared_after
    t0 = time.perf_counter()
    for i, (arch, layers) in enumerate(HYBRID_CHECKS):
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        err = decode_matches_prefill(device, arch, layers, SEED + 40 + 2 * i)
        print(f"phase 4i (a): {arch} cached decode == no-cache forward at "
              f"full width, {layers} layers (and as many encoder layers over "
              f"all frames for an enc-dec model), float32, {LM_CHECK_STEPS} "
              f"steps: max |diff| {err:.3e} "
              f"(limit {LM_SELF_ABS}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"allocated; {time.perf_counter() - t1:.1f} s)")
    launches = {}
    for i, arch in enumerate(HYBRID_ARCHS):
        run = full_width_serve(device, arch, wrappers, SEED + 44 + 3 * i,
                               HYBRID_REPEATS)
        cfg = run["cfg"]
        if cfg.enc_dec:
            shape = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} "
                     f"decoder layers, encoder frames "
                     f"{tuple(run['extra']['encoder_frames'].shape)} bf16")
        else:
            shape = (f"{cfg.n_layers} SSM layers, the shared attention "
                     f"block called {sum(_shared_after(cfg))} times, d_inner "
                     f"{cfg.d_inner}, {cfg.n_ssm_heads} SSM heads, state "
                     f"{cfg.ssm_state}")
        print(f"phase 4i: {cfg.name} at full width and depth "
              f"({run['params']:,} parameters, {shape}, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}, "
              f"{cfg.compute_dtype} compute), {LM_BATCH} sequences x "
              f"{LM_PROMPT}-token prompt + {LM_NEW} new tokens; peak "
              f"{run['build_peak'] / 2**30:.2f} GiB allocated after the "
              f"build, {run['serve_peak'] / 2**30:.2f} GiB through the "
              f"decodes [{card}]")
        if "prime_ms" in run:
            print(f"phase 4i: {cfg.name} priming the caches from the frames "
                  f"(the encoder and every layer's cross K/V, outside the "
                  f"prefill figure): {run['prime_ms']:.3f} ms (median of 3, "
                  f"CUDA events) [{card}]")
        print_lm_serve("4i", run, cfg)
        launches[arch] = run["launches"]
        idle = [name for name in ("uprog_execute", "bitplane_to_planes",
                                  "bitplane_from_planes")
                if launches[arch][name] == 0]
        _check(not idle, f"kernels not launched serving {arch}: {idle}")
        model, prompt, extra = run["model"], run["prompt"], run["extra"]
        t1 = time.perf_counter()
        label = (f"{cfg.name}, {PROFILED_STEPS} cached decode steps after a "
                 "prefill, host pick")
        rows = device_breakdown(f"{label} [{card}]", decode_steps(
            model, cfg, prompt, extra, PROFILED_STEPS))
        if rows:
            bf16 = sum(ms for key, ms, _ in rows if "bfloat16_copy" in key)
            copies = sum(ms for key, ms, _ in rows if "direct_copy" in key)
            print(f"phase 4i: {cfg.name} a decode step: "
                  f"{bf16 / PROFILED_STEPS:.3f} ms of device time in "
                  f"bfloat16_copy kernels (float32 -> bf16 casts: the "
                  f"per-use weight casts and activations), "
                  f"{copies / PROFILED_STEPS:.3f} ms in direct_copy kernels "
                  f"(other copies and casts) [{card}]")
        host_breakdown(label, decode_steps(model, cfg, prompt, extra,
                                           PROFILED_STEPS), PROFILED_STEPS)
        print(f"phase 4i: {cfg.name} took {run['seconds']:.1f} s before the "
              f"profiles, {time.perf_counter() - t1:.1f} s in them")
        del run, model, prompt, extra
        torch.cuda.empty_cache()
    print(f"phase 4i took {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 4g ----------------------------------------------------------------

def train_tolerance(lr: float, steps: int) -> float:
    """The absolute bound on an updated parameter after ``steps`` AdamW
    steps at most ``lr`` each: Adam's first steps move an element by ≈ lr ·
    sign(g), so a near-zero gradient whose sign differs between two
    devices moves it by up to 2 · lr a step."""
    return 2 * lr * steps


def params_close(got, want, bound: float, what: str) -> tuple:
    """Every parameter of model ``got`` within ``bound`` of ``want``'s, and
    at most 0.1 % of the elements beyond 1 % of it.  Returns (largest
    difference, share beyond 1 % of the bound)."""
    want = dict(want.named_parameters())
    worst, n_far, n = 0.0, 0, 0
    for name, p in got.named_parameters():
        d = (p.detach().cpu() - want[name].detach().cpu()).abs()
        worst = max(worst, float(d.max()))
        n_far += int((d > 0.01 * bound).sum())
        n += d.numel()
    _check(worst <= bound and n_far <= 1e-3 * n,
           f"{what}: parameters differ by up to {worst:.3e} (bound "
           f"{bound:.3e}), {n_far} of {n} beyond 1 % of it")
    return worst, n_far / n


def loss_and_grads(model, cfg, batch) -> tuple:
    """The objective and every parameter's gradient of one
    ``make_loss_fn`` backward pass (no update), on the CPU."""
    from repro_torch.train.train_step import make_loss_fn
    for p in model.parameters():
        p.grad = None
    objective, _ = make_loss_fn(cfg)(model, batch)
    objective.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(objective.detach()), grads


def train_models(cfg, seed: int, devices) -> dict:
    """``{device: model}`` of ``cfg`` on each of ``devices`` with the same
    parameters, drawn on the CPU from ``seed``."""
    import torch

    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.transformer import Transformer, model_defs
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(seed),
                         device="cpu")
    return {dev: Transformer(cfg, device=dev).load_params(
        tree_map(lambda t, d=dev: t.to(d), params)) for dev in devices}


def train_step_matches_cpu(device) -> dict:
    """Check (a): one ``make_train_step`` of Qwen1.5-0.5B at full width cut
    to 2 layers, float32 compute (TF32 off), batch 2 × 64, on the card and
    on the CPU from the same parameters: the objective, ``grad_norm`` and
    every gradient within 1e-4 × max|CPU value| (the gradients by one
    ``make_loss_fn`` backward pass on each device, before the step), the
    updated parameters within ``train_tolerances``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 matmul is on; the float32 checks need it off")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), compute_dtype="float32",
                              n_layers=TRAIN_CHECK_LAYERS)
    models = train_models(cfg, SEED + 22, ("cpu", device))
    b, s = TRAIN_CHECK_SHAPE
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    batch = {dev: synthetic_batch(dcfg, 0, device=dev) for dev in models}
    out = {dev: loss_and_grads(m, cfg, batch[dev])
           for dev, m in models.items()}
    (want, want_g), (got, got_g) = out["cpu"], out[device]
    res = {"loss_err": abs(got - want) / abs(want), "grad_err": 0.0}
    _check(res["loss_err"] <= TRAIN_F32_REL, f"full-width step: objective "
           f"{got} on the card, {want} on the CPU")
    for name, g in want_g.items():
        err = float((got_g[name] - g).abs().max())
        bound = TRAIN_F32_REL * float(g.abs().max())
        _check(err <= bound, f"full-width step: gradient of {name} differs "
               f"by {err:.3e} (bound {bound:.3e})")
        res["grad_err"] = max(res["grad_err"],
                              err / max(float(g.abs().max()), 1e-30))
    opt = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS, warmup_steps=10)
    metrics = {}
    for dev, model in models.items():
        step = make_train_step(cfg, opt)
        metrics[dev] = step(init_train_state(model), batch[dev])[1]
    for k in ("loss", "grad_norm", "lr"):
        w, g = float(metrics["cpu"][k]), float(metrics[device][k])
        _check(abs(g - w) <= TRAIN_F32_REL * abs(w), f"full-width step: "
               f"{k} {g} on the card, {w} on the CPU")
    res["lr"] = float(metrics["cpu"]["lr"])
    res["param_err"], res["param_far"] = params_close(
        models[device], models["cpu"], train_tolerance(res["lr"], 1),
        "full-width step")
    res["params"] = sum(p.numel() for p in models["cpu"].parameters())
    return res


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    """Seeded tokens, labels (and M-RoPE positions, encoder frames) on the
    CPU, as ``tests/test_torch_train_families.py`` makes them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.rope == "mrope":
        arrs["mrope_positions"] = np.tile(
            np.arange(s, dtype=np.int32)[None, :, None], (b, 1, 3))
    if cfg.enc_dec:
        arrs["encoder_frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in arrs.items()}


def reduced_trains_like_cpu(device, arch: str) -> float:
    """Check (b): ``arch``'s reduced config (bf16 compute) takes 3 steps on
    the card and on the CPU from the same parameters on the same batches:
    loss and ``grad_norm`` within 5e-2 relative at every step.  Returns the
    largest relative difference."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.params import tree_map
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = get_reduced(arch)
    models = train_models(cfg, SEED + 23, ("cpu", device))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    states = {dev: init_train_state(m) for dev, m in models.items()}
    worst = 0.0
    for i in range(3):
        batch = train_batch(cfg, 4, 16, SEED + 24 + i)
        metrics = {}
        for dev in models:
            states[dev], metrics[dev] = step(
                states[dev], tree_map(lambda t, d=dev: t.to(d), batch))
        for k in ("loss", "grad_norm"):
            w, g = float(metrics["cpu"][k]), float(metrics[device][k])
            err = abs(g - w) / abs(w)
            _check(err <= LM_BF16_REL, f"reduced {arch}, step {i}: {k} {g} "
                   f"on the card, {w} on the CPU")
            worst = max(worst, err)
    return worst


def state_copy(state) -> dict:
    """Every tensor of a training state, copied, by checkpoint key."""
    from repro_torch.distributed.checkpoint import state_leaves
    return {k: t.detach().clone() for k, t in state_leaves(state).items()}


def checkpoint_resumes(device) -> float:
    """Check (c): the reduced config on the card trains 2 steps, saves a
    checkpoint (a temporary directory), trains 3 more; a fresh state
    restored from the checkpoint equals the saved state bit for bit and
    its 3 continued steps give the uninterrupted run's losses within 1e-6
    relative.  Returns the largest relative loss difference."""
    import tempfile

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch.train import setup
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_reduced(TRAIN_ARCH)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    state, _, step = setup(cfg, None, opt, seed=SEED + 25, device=device)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    batches = [synthetic_batch(dcfg, s, device=device) for s in range(5)]
    for s in range(2):
        state, _ = step(state, batches[s])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        try:
            mgr.save(2, state, blocking=True)
            saved = state_copy(state)
            straight = [float(step(state, batches[s])[1]["loss"])
                        for s in range(2, 5)]
            fresh, _, _ = setup(cfg, None, opt, seed=SEED + 26,
                                device=device)
            restored = mgr.restore(mgr.latest_step(), fresh)
        finally:
            mgr.close()
    got = state_copy(restored)
    _check(got.keys() == saved.keys() and all(
        torch.equal(got[k], saved[k]) for k in saved),
        "the restored state differs from the saved one")
    resumed = [float(step(restored, batches[s])[1]["loss"])
               for s in range(2, 5)]
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    _check(err <= 1e-6, f"resumed losses {resumed} differ from the "
           f"uninterrupted run's {straight}")
    return err


def train_variants_match(device) -> dict:
    """Check (d): on the card, the reduced config in float32 compute takes
    3 steps with ``microbatches=2`` and with ``loss_chunk=16`` beside the
    plain step, from the same parameters on the same batches:
    ``grad_norm`` (and, chunked, the loss) within 1e-5 relative at every
    step and the parameters after within ``train_tolerance`` (the CPU
    tests' tolerances).  Returns {variant: largest relative difference}."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = dataclasses.replace(get_reduced(TRAIN_ARCH),
                              compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    batches = [synthetic_batch(dcfg, s, device=device) for s in range(3)]
    runs = {}
    for name, kw in (("plain", {}), ("microbatches=2", {"microbatches": 2}),
                     ("loss_chunk=16", {"loss_chunk": 16})):
        model = train_models(cfg, SEED + 27, (device,))[device]
        state, step = init_train_state(model), make_train_step(cfg, opt,
                                                               **kw)
        metrics = [step(state, b)[1] for b in batches]
        runs[name] = (model, [{k: float(v) for k, v in m.items()}
                              for m in metrics])
    plain, want = runs.pop("plain")
    out = {}
    for name, (model, got) in runs.items():
        keys = ("grad_norm", "loss") if name.startswith("loss") \
            else ("grad_norm",)
        out[name] = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in
                        zip(got, want) for k in keys)
        _check(out[name] <= TRAIN_LOSS_REL, f"{name}: {got} against the "
               f"plain step's {want}")
        params_close(model, plain, train_tolerance(opt.lr, 3), name)
    return out


def train_full_width(device) -> dict:
    """Qwen1.5-0.5B at full width and depth (bf16 compute, remat "full")
    through ``launch.train.setup`` and its step, parameters drawn on the
    card from a seed, on ``synthetic_batch`` at the launcher's defaults
    (batch 8 × seq 256) for 20 steps at the launcher's schedule; the
    batches are made before the first step.  CUDA events around each
    step; the loss must fall.  Returns the numbers to print, the state and
    the step."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import setup
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                      warmup_steps=max(10, TRAIN_STEPS // 20))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, _, step = setup(cfg, None, opt, seed=SEED + 28, device=device)
    _sync(device)
    res = {"cfg": cfg, "opt": opt, "build_peak":
           torch.cuda.max_memory_allocated(),
           "params": sum(p.numel() for p in state.params.parameters())}
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [synthetic_batch(dcfg, s, device=device)
               for s in range(TRAIN_STEPS)]
    events, metrics = [], []
    t0 = time.perf_counter()
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["peak"] = torch.cuda.max_memory_allocated()
    res["step_ms"] = [a.elapsed_time(b) for a, b in events]
    res["losses"] = [float(m["loss"]) for m in metrics]
    res["grad_norms"] = [float(m["grad_norm"]) for m in metrics]
    _check(all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
           and res["losses"][-1] < res["losses"][0],
           f"full-width training: losses {res['losses']}")
    _check(int(state.opt.step) == TRAIN_STEPS, "the step counter is at "
           f"{int(state.opt.step)} after {TRAIN_STEPS} steps")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model FLOPs a step: 6·N·tokens, plus attention's 12·L·d·seq a token
    # (PaLM, arXiv:2204.02311, appendix B); remat's second forward is not
    # counted
    res["flops"] = (6 * res["params"] * tokens
                    + 12 * cfg.n_layers * cfg.d_model * TRAIN_SEQ * tokens)
    res["state"], res["step"], res["batch"] = state, step, batches[-1]
    return res


def train_example() -> float:
    """``python -m repro_torch.examples.train_100m`` at its defaults (20
    steps, batch 8 × 256), in this process, its checkpoint in a temporary
    directory: it must exit 0, which it does iff the loss improved.
    Returns its wall seconds."""
    import tempfile

    from repro_torch.examples import train_100m
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rc = train_100m.main(["--ckpt", tmp])
    _check(rc == 0, f"examples.train_100m exited {rc}")
    return time.perf_counter() - t0


def training_path(device) -> dict:
    """Phase 4g: the full-width run, then checks (a)–(d) and the example.
    Returns the numbers to print."""
    t0 = time.perf_counter()
    res = train_full_width(device)
    res["check_a"] = train_step_matches_cpu(device)
    res["check_b"] = {arch: reduced_trains_like_cpu(device, arch)
                      for arch in TRAIN_FAMILIES}
    res["check_c"] = checkpoint_resumes(device)
    res["check_d"] = train_variants_match(device)
    res["example_s"] = train_example()
    res["phase_s"] = time.perf_counter() - t0
    return res


def optimizer_step(state, opt) -> float:
    """One ``adamw_update`` of the whole state on zero gradients (it
    changes the state), ending in a synchronize; returns its wall
    seconds."""
    import torch

    from repro_torch.train.optimizer import adamw_update
    named = dict(state.params.named_parameters())
    grads = {k: torch.zeros_like(p) for k, p in named.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adamw_update(opt, state.opt, named, grads)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def one_train_step(train: dict) -> float:
    """One more full-width step on the last batch, ending in a
    synchronize; returns its wall seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train["state"], m = train["step"](train["state"], train["batch"])
    float(m["loss"])
    return time.perf_counter() - t0


def print_training(train: dict, launches: dict, card: str) -> None:
    """Print phase 4g's numbers, each line of times with the card's name
    and power limit."""
    cfg, ms = train["cfg"], train["step_ms"]
    timed = sorted(ms[TRAIN_TIMED_FROM:])
    median = statistics.median(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 4g: {cfg.name} trained at full width and depth "
          f"({train['params']:,} float32 parameters, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, tied embeddings "
          f"{cfg.tie_embeddings}, {cfg.compute_dtype} compute, remat "
          f"{cfg.remat!r}), synthetic_batch {TRAIN_BATCH} x {TRAIN_SEQ} = "
          f"{tokens} tokens a step, {TRAIN_STEPS} steps, warmup "
          f"{train['opt'].warmup_steps} [{card}]")
    print(f"phase 4g: loss {train['losses'][0]:.4f} -> "
          f"{train['losses'][-1]:.4f}; grad_norm {train['grad_norms'][0]:.4f}"
          f" -> {train['grad_norms'][-1]:.4f}; {train['seconds']:.2f} s for "
          f"the {TRAIN_STEPS} steps [{card}]")
    print(f"phase 4g: {median:.2f} ms a training step (median of steps "
          f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS}, CUDA events; min "
          f"{timed[0]:.2f}, max {timed[-1]:.2f}; steps 1-2 "
          f"{ms[0]:.1f}, {ms[1]:.1f}); {tokens / median * 1e3:,.0f} tokens/s;"
          f" MFU {100 * train['flops'] / (median / 1e3) / BF16_FLOPS_PER_S:.2f}"
          f"% ({train['flops'] / 1e12:.3f} model TFLOP a step over "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16) [{card}]")
    print(f"phase 4g: peak {train['build_peak'] / 2**30:.2f} GiB allocated "
          f"after the build, {train['peak'] / 2**30:.2f} GiB through the "
          f"steps (max_memory_allocated) [{card}]")
    a = train["check_a"]
    print(f"phase 4g (a): one step at full width, {TRAIN_CHECK_LAYERS} layers "
          f"({a['params']:,} parameters), float32, batch "
          f"{TRAIN_CHECK_SHAPE[0]} x {TRAIN_CHECK_SHAPE[1]}, card vs CPU: "
          f"objective {a['loss_err']:.3e} relative, gradients "
          f"{a['grad_err']:.3e} x max|grad| (limit {TRAIN_F32_REL}); "
          f"parameters after the step max |diff| {a['param_err']:.3e} (bound "
          f"2 x lr = {2 * a['lr']:.3e}), {a['param_far']:.2e} of the "
          "elements beyond 1 % of it")
    for arch, err in train["check_b"].items():
        print(f"phase 4g (b): reduced {arch}, 3 steps, card vs CPU: loss and "
              f"grad_norm within {err:.3e} relative (limit {LM_BF16_REL})")
    print(f"phase 4g (c): checkpoint restored bit for bit; resumed losses "
          f"within {train['check_c']:.3e} relative of the uninterrupted run's"
          " (limit 1e-06)")
    for name, err in train["check_d"].items():
        print(f"phase 4g (d): {name} vs the plain step, 3 steps: within "
              f"{err:.3e} relative (limit {TRAIN_LOSS_REL})")
    print(f"phase 4g: examples.train_100m at its defaults exited 0 in "
          f"{train['example_s']:.1f} s; phase 4g took {train['phase_s']:.1f} "
          f"s; launches {launches} [{card}]")


# -- phase 4h ----------------------------------------------------------------

def vote_check(cfg, opt, mesh, state, batch) -> dict:
    """Check (a): on the first batch's gradients g (error feedback 0), the
    compressed step's vote over the one-rank group (pack, NCCL all-gather,
    majority, scale) equals sign(g + e) · mean|g + e| of each leaf
    computed plainly on the card: signs exactly, each leaf's scale within
    1e-6 relative of a float64 mean, the new error feedback exactly g + e
    − decoded.  Returns the numbers to print and the inputs that time the
    exchange."""
    import torch

    from repro_torch.models.transformer import leaf_names
    from repro_torch.train.train_step import (make_compressed_train_step,
                                              make_loss_fn)
    inner, _ = make_compressed_train_step(cfg, opt, mesh)
    model = state.params
    named = dict(model.named_parameters())
    objective, _ = make_loss_fn(cfg, loss_chunk=cfg.loss_chunk)(model, batch)
    objective.backward()
    # the reference's leaves: a stacked leaf is every layer's tensor
    leaves = leaf_names(cfg)
    keys = [k for names in leaves for k in names]
    gfs = [named[k].grad.float() + state.error_fb[k] for k in keys]
    for p in named.values():
        p.grad = None
    decoded, new_err = inner.exchange(gfs)
    worst, i = 0.0, 0
    for names in leaves:
        flat = torch.cat([g.reshape(-1) for g in gfs[i:i + len(names)]])
        dec = torch.cat(decoded[i:i + len(names)])
        err = torch.cat(new_err[i:i + len(names)])
        i += len(names)
        scale = float(flat.abs().double().mean())
        _check(torch.equal(dec > 0, flat >= 0), f"vote of {names[0]}: a sign "
               "differs from sign(g + e)")
        mags = dec.abs()
        _check(bool((mags == mags[0]).all()), f"{names[0]}: one scale a leaf")
        worst = max(worst, abs(float(mags[0]) - scale) / max(scale, 1e-30))
        _check(torch.equal(err, flat - dec), f"{names[0]}: error feedback")
    _check(worst <= 1e-6, f"leaf scales off by {worst:.3e} relative")
    return {"scale_err": worst, "leaves": len(leaves), "gfs": gfs,
            "exchange": inner.exchange}


def event_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def exchange_ms(check: dict, reps: int = 5) -> dict:
    """The vote's time on the full-width gradients of check (a), through
    the step's own ``exchange``: a CUDA event at its start and at each
    part's end (its ``mark`` hook: scales, concat, pack, all_gather, vote,
    decode), median over ``reps`` calls after one warm call of the whole
    and of each part."""
    import torch

    def one() -> list:
        marks = [("", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(part):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((part, ev))
        check["exchange"](check["gfs"], mark=mark)
        marks[-1][1].synchronize()
        return marks

    one()
    runs = []
    for _ in range(reps):
        marks = one()
        parts = {"exchange": marks[0][1].elapsed_time(marks[-1][1])}
        for (_, a), (part, b) in zip(marks, marks[1:]):
            parts[part] = parts.get(part, 0.0) + a.elapsed_time(b)
        runs.append(parts)
    out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    out["n"] = sum(g.numel() for g in check["gfs"])
    out["words"] = -(-out["n"] // 32)
    return out


def timed_steps(step, state, batches) -> tuple:
    """CUDA-event ms of each step and the metrics, the state after."""
    import torch
    events, metrics = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events], metrics, state


def compressed_full_width(device) -> dict:
    """Phase 4h (a): Qwen1.5-0.5B at full width and depth through
    ``launch.train.setup(..., compressed=True, exchange="packed")`` on a
    (1, 1) mesh over an NCCL group of one rank, 4g's batches and schedule,
    20 steps; the loss must fall.  Check (a) before the first step; the
    vote timed on its gradients; then 10 plain steps through ``setup`` on
    the same mesh (a mesh of one rank places nothing)."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_mesh, init_distributed, setup
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    t0 = time.perf_counter()
    created = init_distributed(device)
    try:
        mesh = build_mesh(device_type="cuda")
        _check(dist.get_backend() == "nccl" and mesh.size() == 1,
               f"4h (a) runs on one NCCL rank, not {dist.get_backend()} x "
               f"{mesh.size()}")
        cfg = get_config(TRAIN_ARCH)
        opt = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                          warmup_steps=max(10, TRAIN_STEPS // 20))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, step = setup(cfg, mesh, opt, compressed=True,
                               exchange="packed", seed=SEED + 40,
                               device=device)
        _sync(device)
        res = {"cfg": cfg, "build_peak": torch.cuda.max_memory_allocated(),
               "params": sum(p.numel() for p in state.params.parameters())}
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
        batches = [synthetic_batch(dcfg, s, device=device)
                   for s in range(TRAIN_STEPS)]
        check = vote_check(cfg, opt, mesh, state, batches[0])
        res["check"] = check["scale_err"], check["leaves"]
        res["exchange"] = exchange_ms(check)
        del check
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res["step_ms"], metrics, state = timed_steps(step, state, batches)
        res["peak"] = torch.cuda.max_memory_allocated()
        res["losses"] = [float(m["loss"]) for m in metrics]
        _check(all(math.isfinite(x) for x in res["losses"])
               and res["losses"][-1] < res["losses"][0],
               f"compressed full-width training: losses {res['losses']}")
        del state, step
        torch.cuda.empty_cache()
        plain, _, plain_step = setup(cfg, mesh, opt, seed=SEED + 41,
                                     device=device)
        res["plain_ms"] = timed_steps(plain_step, plain,
                                      batches[:DIST_PLAIN_STEPS])[0]
    finally:
        if created:
            dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    return res


def dist_model(cfg, seed: int, device):
    """The reduced model of 4h (b): drawn on the CPU from ``seed`` (the
    same values on every rank and device), on ``device``."""
    import torch

    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.transformer import Transformer, model_defs
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(seed),
                         device="cpu")
    return Transformer(cfg, device=device).load_params(
        tree_map(lambda t: t.to(device), params))


def dist_rank(rank: int, world: int, device: str, out_dir: str) -> None:
    """One rank of phase 4h (b), ``device`` "cuda" (every rank on cuda:0)
    or "cpu": the compressed exchanges on a (world, 1) mesh, 3 steps each;
    on the card also the pipeline and the sharded plain step.  Writes its
    results, and its own launches of each SIMDRAM kernel, to
    ``out_dir``."""
    import dataclasses

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.compat import (
        shard_map_compat, stage_gloo_all_gather_through_host)
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  stack_stage_params)
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import sharded_step
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_compressed_train_step,
                                              make_train_step)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if device == "cuda":
        torch.cuda.set_device(0)
        staged = stage_gloo_all_gather_through_host()   # noqa: F841 — kept
    cfg = dataclasses.replace(get_reduced(TRAIN_ARCH),
                              compute_dtype="float32")
    opt = AdamWConfig(lr=DIST_LR, warmup_steps=2, total_steps=6)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    batches = [synthetic_batch(dcfg, s, device=device)
               for s in range(DIST_STEPS)]
    mesh = make_mesh((world, 1), ("data", "model"), device)
    out = {}
    for name, (exchange, two_phase) in DIST_EXCHANGES.items():
        model = dist_model(cfg, SEED + 42, device)
        state = init_train_state(model, compressed=True)
        inner, axes = make_compressed_train_step(
            cfg, opt, mesh, two_phase=two_phase, exchange=exchange)
        step = shard_map_compat(inner, mesh, set(axes), in_specs=(
            None, {"tokens": ("data",), "labels": ("data",)}))
        out[f"{name}/loss"] = np.array([float(step(state, b)[1]["loss"])
                                        for b in batches])
        for k, p in model.named_parameters():
            out[f"{name}/{k}"] = p.detach().cpu().numpy()
    if device == "cuda":
        pipe = make_mesh((world,), ("pipe",), device)
        for name, (m, mb, d, grad) in PIPE_CASES.items():
            gen = torch.Generator().manual_seed(SEED + 43)
            ws = [(torch.randn(d, d, generator=gen) * 0.3).to(device)
                  for _ in range(world)]
            x = torch.randn(m, mb, d, generator=gen).to(device)
            w = distribute_tensor(stack_stage_params(ws), pipe, [Shard(0)],
                                  src_data_rank=None).requires_grad_(grad)
            y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": w},
                               x, mesh=pipe)
            seq = [wi.clone().requires_grad_(grad) for wi in ws]
            h = x
            for wi in seq:
                h = torch.tanh(h @ wi)
            if rank == world - 1:
                out[f"pipe/{name}/forward"] = np.array(
                    float((y - h).abs().max()))
            if grad:
                (y ** 2).sum().backward()
                (h ** 2).sum().backward()
                want = torch.stack([wi.grad for wi in seq])
                out[f"pipe/{name}/grad"] = np.array(
                    float((w.grad.full_tensor() - want).abs().max()))
        mesh22 = make_mesh((2, world // 2), ("data", "model"), device)
        sharded = dist_model(cfg, SEED + 44, device)
        tree_shardings(sharded, mesh22)
        step = sharded_step(make_train_step(cfg, opt), mesh22)
        state = init_train_state(sharded)
        out["sharded/loss"] = np.array([float(step(state, b)[1]["loss"])
                                        for b in batches])
        single = dist_model(cfg, SEED + 44, device)
        one = make_train_step(cfg, opt)
        state = init_train_state(single)
        out["single/loss"] = np.array([float(one(state, b)[1]["loss"])
                                       for b in batches])
        whole = {k: p.full_tensor() if isinstance(p, DTensor) else p
                 for k, p in sharded.named_parameters()}
        diffs = [(whole[k] - p).abs() for k, p in single.named_parameters()]
        out["sharded/param_err"] = np.array(max(float(d.max())
                                                for d in diffs))
        out["sharded/param_far"] = np.array(
            sum(int((d > 1e-5).sum()) for d in diffs)
            / sum(d.numel() for d in diffs))
    out.update({f"launches/{name}": np.array(w.launches)
                for name, w in wrappers.items()})
    np.savez(f"{out_dir}/{device}_{rank}.npz", **out)


def distributed_path(device) -> dict:
    """Phase 4h: (a) the full-width compressed run, then (b) the ranks on
    the card and on the CPU; every comparison of (b) checked here."""
    import tempfile

    import numpy as np

    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    res = {"a": compressed_full_width(device)}
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        spawn_ranks(dist_rank, DIST_RANKS, ("cuda", tmp), timeout=300)
        res["card_ranks_s"] = time.perf_counter() - t1
        spawn_ranks(dist_rank, DIST_RANKS, ("cpu", tmp), timeout=300)
        card = [dict(np.load(f"{tmp}/cuda_{r}.npz"))
                for r in range(DIST_RANKS)]
        cpus = [dict(np.load(f"{tmp}/cpu_{r}.npz"))
                for r in range(DIST_RANKS)]
    res["rank_launches"] = {
        k.split("/", 1)[1]: sum(int(c[k]) for c in card + cpus)
        for k in card[0] if k.startswith("launches/")}
    cpu = cpus[0]
    bound = 2 * DIST_LR * DIST_STEPS
    worst = {}
    for name in DIST_EXCHANGES:
        loss = np.abs(card[0][f"{name}/loss"] - cpu[f"{name}/loss"]).max() \
            / np.abs(cpu[f"{name}/loss"]).max()
        diffs = {k: np.abs(card[0][k] - cpu[k]) for k in cpu
                 if k.startswith(f"{name}/") and not k.endswith("/loss")}
        params = max(float(d.max()) for d in diffs.values())
        # only an element whose vote turned may lie beyond DIST_FAR
        far = {k: int((d > DIST_FAR).sum()) for k, d in diffs.items()}
        turned = [k for k, n in far.items()
                  if n > max(1, 1e-3 * diffs[k].size)]
        for r in range(1, DIST_RANKS):
            _check(all(np.array_equal(card[r][k], card[0][k])
                       for k in card[0] if k.startswith(f"{name}/")),
                   f"{name}: rank {r} holds other values than rank 0")
        _check(loss <= TRAIN_LOSS_REL and params <= bound and not turned,
               f"{name} on the card vs the CPU: loss {loss:.3e} relative "
               f"(limit {TRAIN_LOSS_REL}), parameters {params:.3e} (bound "
               f"{bound:.3e}), more than 0.1 % of a leaf beyond {DIST_FAR} "
               f"in {turned}")
        worst[name] = (float(loss), params, sum(far.values()))
    res["exchanges"] = worst
    pipe = {k: max(float(c[k]) for c in card if k in c) for k in card[-1]
            if k.startswith("pipe/")}
    for k, v in pipe.items():
        _check(v <= (1e-5 if k.endswith("forward") else 1e-4),
               f"pipeline {k}: {v:.3e} from the sequential composition")
    res["pipe"] = pipe
    c0 = card[0]
    loss = float(np.abs(c0["sharded/loss"] - c0["single/loss"]).max()
                 / np.abs(c0["single/loss"]).max())
    _check(loss <= TRAIN_F32_REL and float(c0["sharded/param_err"])
           <= DIST_LR * DIST_STEPS and float(c0["sharded/param_far"]) <= 1e-3,
           f"sharded (2, 2) step vs one rank: loss {loss:.3e}, parameters "
           f"{float(c0['sharded/param_err']):.3e}")
    res["sharded"] = (loss, float(c0["sharded/param_err"]),
                      float(c0["sharded/param_far"]))
    res["seconds"] = time.perf_counter() - t0
    return res


def print_distributed(dist: dict, launches: dict, card: str) -> None:
    """Print phase 4h's numbers, each line of times with the card's name
    and power limit."""
    a = dist["a"]
    cfg, ms = a["cfg"], a["step_ms"]
    timed = sorted(ms[TRAIN_TIMED_FROM:])
    median = statistics.median(timed)
    plain = statistics.median(a["plain_ms"][TRAIN_TIMED_FROM:])
    ex = a["exchange"]
    print(f"phase 4h (a): {cfg.name} at full width and depth "
          f"({a['params']:,} parameters), compressed DP (packed) through "
          f"launch.train.setup on a (1, 1) mesh over an NCCL group of one "
          f"rank, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps: "
          f"loss {a['losses'][0]:.4f} -> {a['losses'][-1]:.4f} [{card}]")
    print(f"phase 4h (a): {median:.2f} ms a step (median of steps "
          f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS}, CUDA events; min "
          f"{timed[0]:.2f}, max {timed[-1]:.2f}); the plain step on the same "
          f"mesh {plain:.2f} ms (median of steps {TRAIN_TIMED_FROM + 1}-"
          f"{DIST_PLAIN_STEPS}) [{card}]")
    print(f"phase 4h (a): the vote alone on the step's gradients "
          f"{ex['exchange']:.2f} ms ({100 * ex['exchange'] / median:.1f} % of"
          f" a step); its parts, timed inside the step's own exchange: leaf "
          f"scales mean|g + e| {ex['scales']:.2f}, concat {ex['concat']:.2f},"
          f" pack {ex['pack']:.2f}, all_gather {ex['all_gather']:.3f}, "
          f"majority {ex['vote']:.2f}, decode and error feedback "
          f"{ex['decode']:.2f} ms (medians of 5, CUDA events) [{card}]")
    print(f"phase 4h (a): {ex['n']:,} parameters -> {ex['words']:,} packed "
          f"words = {4 * ex['words'] / 1e6:.1f} MB a rank a step, against "
          f"{4 * ex['n'] / 1e9:.3f} GB for a float32 all-reduce")
    print(f"phase 4h (a): peak {a['build_peak'] / 2**30:.2f} GiB allocated "
          f"after the build, {a['peak'] / 2**30:.2f} GiB through the steps "
          f"[{card}]")
    print(f"phase 4h (a) check: the vote over one rank == sign(g + e) * "
          f"mean|g + e| on all {a['check'][1]} leaves (signs exact, scales "
          f"within {a['check'][0]:.2e} relative, limit 1e-6)")
    print(f"phase 4h (b): {DIST_RANKS} ranks on cuda:0 over gloo "
          f"({dist['card_ranks_s']:.1f} s with their start); the eager "
          "collectives (all-gather, all-reduce, all-to-all) take CUDA "
          "tensors; DTensor's functional all-gather crashes on them and is "
          "staged through host memory (stage_gloo_all_gather_through_host)")
    for name, (loss, params, far) in dist["exchanges"].items():
        print(f"phase 4h (b): compressed {name}, {DIST_STEPS} steps, card vs "
              f"CPU ({DIST_RANKS} gloo ranks each): loss {loss:.3e} relative "
              f"(limit {TRAIN_LOSS_REL}), parameters {params:.3e} (bound "
              f"{2 * DIST_LR * DIST_STEPS:.3e}), {far} elements beyond "
              f"{DIST_FAR} (at most one or 0.1 % a leaf); ranks equal")
    for k, v in dist["pipe"].items():
        print(f"phase 4h (b): {k} on the card vs the sequential composition:"
              f" {v:.3e}")
    loss, err, far = dist["sharded"]
    print(f"phase 4h (b): sharded plain step on a (2, 2) mesh vs one rank, "
          f"{DIST_STEPS} steps: loss {loss:.3e} relative (limit "
          f"{TRAIN_F32_REL}), parameters {err:.3e} (bound "
          f"{DIST_LR * DIST_STEPS:.1e}), {far:.2e} beyond 1e-5")
    print(f"phase 4h took {dist['seconds']:.1f} s; launches {launches} "
          f"[{card}]")


# -- phase 5 -----------------------------------------------------------------

def cuda_ms(fn, inputs: list, iters: int) -> float:
    """Mean device time of ``fn(*inputs[i % len])`` over ``iters`` calls,
    after two warm-up calls, with CUDA events; the inputs rotate so the
    working set exceeds the 50 MB L2 where it can."""
    import torch
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, inputs: list, kernel: str, iters: int = 20,
                tries: int = 3) -> float | None:
    """Mean device time of the kernel named ``kernel`` per the profiler over
    ``iters`` calls ``fn(*inputs[i % len])``.  The profiler has dropped a
    kernel's events from a trace: a trace with fewer ``kernel`` events than
    ``fn``'s launch counter (else ``iters``) rose by is taken again in a
    fresh profiler session, up to ``tries`` times (None if none was
    whole)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        before = getattr(fn, "launches", 0)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(iters):
                    fn(*inputs[i % len(inputs)])
                torch.cuda.synchronize()
        except RuntimeError as exc:        # CUPTI tracing not permitted here
            print(f"profiler unavailable: {exc}")
            return None
        launched = getattr(fn, "launches", before + iters) - before
        rows = [e for e in prof.key_averages() if kernel in e.key]
        seen = sum(e.count for e in rows)
        if rows and seen >= launched:
            return sum(e.device_time_total for e in rows) / iters / 1e3
        print(f"profiler: {seen} {kernel} events for {launched} launches; "
              "tracing again")
    return None


def copy_ms(inputs: list, iters: int = 20) -> float | None:
    """Mean device time per the profiler of ``x.clone()`` over the element
    vectors ``inputs`` (each read once, written once): what a plain copy of
    a transposition call's input costs on this card, as a yardstick."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                inputs[i % len(inputs)].clone()
            torch.cuda.synchronize()
    except RuntimeError as exc:        # CUPTI tracing not permitted here
        print(f"profiler unavailable: {exc}")
        return None
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / iters / 1e3 if total else None


def device_breakdown(label: str, run) -> list | None:
    """Run a path once more under the profiler (``run()`` returns its wall
    seconds) and print how much of its wall time the device was busy, and
    with which kernels.  Returns the (kernel, device ms, count) rows (None
    where the profiler cannot trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            seconds = run()
    except RuntimeError as exc:        # CUPTI tracing not permitted here
        print(f"profiler unavailable: {exc}")
        return None
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    print(f"{label} under the profiler: {seconds:.3f} s wall, device busy "
          f"{busy:.3f} ms ({100 * busy / 1e3 / seconds:.2f}%) in "
          f"{sum(n for _, _, n in rows)} device ops")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5} {key[:90]}")
    torch.cuda.synchronize()
    return rows


def host_breakdown(label: str, run, steps: int) -> None:
    """Run a path once more under the profiler's CPU tracing and print the
    torch ops it issued a step and the host time they took by op (the
    tracing itself slows every op, so read the shares, not the sums)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seconds = run()
    rows = [(e.key, e.self_cpu_time_total / 1e3, e.count)
            for e in prof.key_averages()]
    total = sum(ms for _, ms, _ in rows)
    ops = sum(n for key, _, n in rows if key.startswith("aten::"))
    print(f"{label} under CPU tracing: {seconds:.3f} s wall, {total:.1f} ms "
          f"self CPU in {ops} aten ops, nested calls "
          f"included ({ops / steps:.0f} a step)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:9.3f} ms  x{count:<6} {key[:80]}")


def fsm_ops_per_word(cmds) -> int:
    """Integer operations one word column needs for a command stream: one
    3-input logic op per MAJ, one NOT more where a MAJ writes a complement,
    one NOT per COPY whose source and destination differ in polarity."""
    op, a, b, c = (cmds[:, i] for i in range(4))
    maj = op == 1
    return int(maj.sum() + (maj & ((a < 0) | (b < 0) | (c < 0))).sum()
               + (~maj & ((a < 0) != (b < 0))).sum())


def bound_ms(nbytes: float, ops: float, int_ops_per_s: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_bitserial(device, launches: int, popc_per_s: float) -> list:
    """K3 at FC6 and FC7: events and profiler times beside the plain
    version, ``torch._int_mm`` on the unpacked ±1 int8 operands (the
    unpacking not timed) and the bounds."""
    import torch

    from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                      bitserial_matmul_plain,
                                                      unpack_signs)
    rows_out = []
    for i, (label, m, n, k) in enumerate(XNOR_SHAPES[:2]):
        kw = k // 32
        in_bytes = (m + n) * kw * 4
        copies = max(2, min(24, int(64e6 // in_bytes) + 1))   # > L2 a round
        inputs = [(packed_words(device, m, kw, SEED + 200 + 2 * c),
                   packed_words(device, n, kw, SEED + 201 + 2 * c), k)
                  for c in range(copies)]
        a, b, _ = inputs[0]
        ua, ub = unpack_signs(a), unpack_signs(b)
        # the library call computes the same function, exactly (int32 sums)
        _equal(torch._int_mm(ua, ub.t()), bitserial_matmul(a, b, k),
               f"torch._int_mm vs bitserial_matmul {label}")
        lib_inputs = [(ua, ub.t())]
        t_popc = m * n * kw / popc_per_s * 1e3
        t_int8 = 2 * m * n * k / INT8_TC_OPS_PER_S * 1e3
        t_bytes = (in_bytes + m * n * 4) / HBM_BYTES_PER_S * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_int8 else \
            (t_int8, "operations")
        rows_out.append({
            "name": f"bitserial_matmul/{label}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
            "replaces": "src/repro/kernels/bitserial_matmul.py:58",
            "launches": launches,
            "max_abs_err": MAX_ABS_ERR["bitserial_matmul"],
            "ms": cuda_ms(bitserial_matmul, inputs, iters=50),
            "plain_ms": cuda_ms(bitserial_matmul_plain, inputs[:1], iters=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(torch._int_mm, lib_inputs, iters=50),
            "kernel_ms": profiled_ms(bitserial_matmul, inputs[:1],
                                     "xnor_wgmma_kernel"),
            "popc_bound_ms": t_popc, "int8_tc_bound_ms": t_int8,
            "bytes_bound_ms": t_bytes,
            "shape": f"M={m} N={n} K={k}"})
        del inputs, lib_inputs, ua, ub
    return rows_out


def fsm_inputs(device, op: str, n_bits: int) -> tuple:
    """The trace of ``op`` at ``n_bits`` and ``uprog_execute`` argument
    tuples on 16 × 2,048-word row files (copies, so the files together
    exceed the 50 MB L2 where they can)."""
    import torch

    from repro_torch.core.trace import compile_trace
    trace = compile_trace(op, n_bits)[1]
    cmds = torch.as_tensor(trace.cmds, dtype=torch.int32, device=device)
    file_bytes = trace.n_rows * BANKS * WORDS * 4
    copies = max(2, min(8, int(200e6 // file_bytes)))
    return trace, [(cmds, random_rows(trace, BANKS, WORDS, device, SEED + i),
                    False) for i in range(copies)]


def element_words(device) -> list:
    """24 random int32[16 × 65,536] element vectors (24 × 4 MB > L2)."""
    import torch
    g = torch.Generator(device=device).manual_seed(SEED)
    return [torch.randint(-2**31, 2**31, (BANKS * LANES,), dtype=torch.int32,
                          device=device, generator=g) for _ in range(24)]


def measure(device, launches: dict, int_ops_per_s: float) -> list:
    from repro_torch.kernels.bitplane_transpose import (
        from_planes, from_planes_plain, to_planes, to_planes_plain)
    from repro_torch.kernels.uprog_executor import (uprog_execute,
                                                    uprog_execute_plain)
    fsm_src = "src/repro_torch/kernels/csrc/uprog_executor.cu"
    k2_src = "src/repro_torch/kernels/csrc/bitplane_transpose.cu"
    rows_out = []
    for op, n_bits in FSM_TIMED:
        trace, inputs = fsm_inputs(device, op, n_bits)
        ms = cuda_ms(uprog_execute, inputs, iters=50)
        plain_ms = cuda_ms(uprog_execute_plain, [inputs[0][:2]], iters=1)
        kernel_ms = profiled_ms(uprog_execute, inputs, "uprog_execute")
        file_bytes = trace.n_rows * BANKS * WORDS * 4
        nbytes = 2 * file_bytes + trace.cmds.nbytes
        ops = fsm_ops_per_word(trace.cmds) * BANKS * WORDS
        bound, by = bound_ms(nbytes, ops, int_ops_per_s)
        rows_out.append({
            "name": f"uprog_execute/{op}_{n_bits}b", "route": "cuda",
            "source": fsm_src,
            "replaces": "src/repro/kernels/uprog_executor.py:76",
            "launches": launches["uprog_execute"],
            "max_abs_err": MAX_ABS_ERR["uprog_execute"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "kernel_ms": kernel_ms,
            "shape": f"R={trace.n_rows} N={trace.n_commands} "
                     f"steps={len(trace.cmds)} {BANKS}x{WORDS} words"})
    lanes = BANKS * LANES
    words = element_words(device)
    copy_yardstick = copy_ms(words)
    for n_bits in (8, 1, 32):    # 8: the main path's width; 1, 32: scaling
        vals = [(v, n_bits) for v in words]
        planes = [(to_planes_plain(v, n_bits), True) for v in words]
        nbytes = lanes * 4 + n_bits * lanes // 8
        bound, by = bound_ms(nbytes, n_bits * lanes, int_ops_per_s)
        for name, fn, plain, inputs in (
                ("bitplane_to_planes", to_planes, to_planes_plain, vals),
                ("bitplane_from_planes", from_planes, from_planes_plain,
                 planes)):
            rows_out.append({
                "name": name if n_bits == 8 else f"{name}/{n_bits}_planes",
                "route": "cuda", "source": k2_src,
                "replaces": "src/repro/kernels/bitplane_transpose.py:66",
                "launches": launches[name], "max_abs_err": MAX_ABS_ERR[name],
                "ms": cuda_ms(fn, inputs, iters=200),
                "plain_ms": cuda_ms(plain, inputs, iters=20),
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "kernel_ms": profiled_ms(fn, inputs, name.split("_", 1)[1]),
                # one input again and again: its reads hit the L2
                "kernel_warm_ms": profiled_ms(fn, inputs[:1],
                                              name.split("_", 1)[1]),
                "copy_ms": copy_yardstick,
                "shape": f"{n_bits} planes x {lanes} lanes"})
        del vals, planes
    return rows_out


def build_old(old_src: Path):
    """Build an earlier kernel source into ``chiprun_out/ab/`` (the source
    is copied there too) and load it."""
    import ctypes
    import shutil

    from repro_torch.kernels import _build
    out_dir = ROOT / "chiprun_out" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / old_src.name
    if src.resolve() != old_src.resolve():
        shutil.copyfile(old_src, src)
    lib_path = out_dir / f"{old_src.stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)],
                          capture_output=True, text=True)
    _check(proc.returncode == 0, f"nvcc {src}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "smem" in line:
            print(f"  ptxas (old {old_src.name}): {line.strip()}")
    return ctypes.CDLL(str(lib_path))


def in_turns(label: str, runs: dict, order: tuple, kernel: str | None,
             iters: int) -> dict:
    """Time each of ``runs`` (who → (fn, inputs)) in ``order`` by CUDA
    events and, when ``kernel`` is named, by the profiler's kernel time."""
    times: dict = {}
    for who in order:
        fn, inputs = runs[who]
        t = times.setdefault(who, {"events_ms": [], "kernel_ms": []})
        t["events_ms"].append(cuda_ms(fn, inputs, iters=iters))
        if kernel is not None:
            t["kernel_ms"].append(profiled_ms(fn, inputs, kernel))
    print(f"A/B {label}: " + "; ".join(
        f"{who} " + ", ".join(
            f"{key[:-3]} " + " / ".join(f"{v:.5f}" if v is not None else "-"
                                        for v in vals) + " ms"
            for key, vals in t.items() if vals)
        for who, t in times.items()))
    return times


def ab_bitserial(device, lib) -> list:
    """An earlier K3 against the current one and ``torch._int_mm`` in turns
    at FC6 and FC7, on the same inputs: old, new, library, library, new,
    old (its C interface: ``bitserial_matmul_launch(a, b, out, m, n, kw,
    k_bits, device, stream)``)."""
    import ctypes

    import torch

    from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                      unpack_signs)
    lib.bitserial_matmul_launch.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.bitserial_matmul_launch.restype = ctypes.c_int

    def old(a, b, k):
        m, kw = a.shape
        out = torch.empty((m, b.shape[0]), dtype=torch.int32, device=a.device)
        err = lib.bitserial_matmul_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, b.shape[0], kw, k,
            a.device.index, torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"old bitserial_matmul launch failed ({err})")
        return out

    rows = []
    for i, (label, m, n, k) in enumerate(XNOR_SHAPES[:2]):
        kw = k // 32
        copies = max(2, min(24, int(64e6 // ((m + n) * kw * 4)) + 1))
        inputs = [(packed_words(device, m, kw, SEED + 300 + 2 * c),
                   packed_words(device, n, kw, SEED + 301 + 2 * c), k)
                  for c in range(copies)]
        a, b, _ = inputs[0]
        _equal(old(a, b, k), bitserial_matmul(a, b, k), f"A/B {label}")
        lib_inputs = [(unpack_signs(a), unpack_signs(b).t())]
        runs = {"old": (old, inputs), "new": (bitserial_matmul, inputs),
                "library": (torch._int_mm, lib_inputs)}
        times = in_turns(label, runs, ("old", "new", "library", "library",
                                       "new", "old"), None, iters=50)
        rows.append({"shape": label, "m": m, "n": n, "k": k,
                     **{who: t["events_ms"] for who, t in times.items()}})
        del inputs, lib_inputs, runs
    return rows


def ab_uprog(device, lib) -> list:
    """An earlier K1 against the current one in turns (old, new, new, old)
    at multiplication/8b and division/32b, on the same row files."""
    import ctypes

    import torch

    from repro_torch.kernels.uprog_executor import uprog_execute
    lib.uprog_execute_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.uprog_execute_launch.restype = ctypes.c_int

    def old(cmds, rows, check=False):
        out = torch.empty_like(rows)
        n_rows, words = rows.shape[-2], rows.shape[-1]
        err = lib.uprog_execute_launch(
            cmds.data_ptr(), cmds.shape[0], rows.data_ptr(), out.data_ptr(),
            n_rows, words, rows.numel() // n_rows, rows.device.index,
            torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"old uprog_execute launch failed ({err})")
        return out

    out = []
    for op, n_bits in FSM_TIMED:
        trace, inputs = fsm_inputs(device, op, n_bits)
        cmds, rows, _ = inputs[0]
        _equal(old(cmds, rows), uprog_execute(cmds, rows), f"A/B {op}")
        label = f"{op}/{n_bits}b"
        times = in_turns(label, {"old": (old, inputs),
                                 "new": (uprog_execute, inputs)},
                         ("old", "new", "new", "old"), "uprog_execute",
                         iters=20)
        out.append({"shape": f"{label} R={trace.n_rows} "
                             f"steps={len(trace.cmds)}", **times})
        del inputs
    return out


def ab_to_planes(device, lib) -> list:
    """An earlier to-planes kernel against the current one in turns (old,
    new, new, old) at 1, 8 and 32 planes × 16 × 65,536 lanes."""
    import ctypes

    import torch

    from repro_torch.kernels.bitplane_transpose import to_planes
    lib.bitplane_to_planes_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.bitplane_to_planes_launch.restype = ctypes.c_int

    def old(values, n_bits):
        out = torch.empty((n_bits, values.numel() // 32), dtype=torch.int32,
                          device=values.device)
        err = lib.bitplane_to_planes_launch(
            values.data_ptr(), out.data_ptr(), out.shape[1], n_bits,
            values.device.index, torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"old to_planes launch failed ({err})")
        return out

    words = element_words(device)
    out = []
    for n_bits in (1, 8, 32):
        inputs = [(v, n_bits) for v in words]
        _equal(old(*inputs[0]), to_planes(*inputs[0]), f"A/B {n_bits} planes")
        times = in_turns(f"to_planes/{n_bits}_planes",
                         {"old": (old, inputs), "new": (to_planes, inputs)},
                         ("old", "new", "new", "old"), "to_planes",
                         iters=200)
        out.append({"shape": f"{n_bits} planes x {BANKS * LANES} lanes",
                    **times})
    return out


AB_RUNS = {"bitserial_matmul": ab_bitserial, "uprog_executor": ab_uprog,
           "bitplane_transpose": ab_to_planes}


def parse_args(args: list) -> dict | None:
    """``--ab-old [KERNEL=]OLD.cu`` pairs → {KERNEL: OLD.cu path}, or None
    on a bad command line."""
    ab_old = {}
    while args:
        if args[0] != "--ab-old" or len(args) < 2:
            return None
        kernel, _, src = args[1].rpartition("=")
        kernel = kernel or "bitserial_matmul"
        if kernel not in AB_RUNS:
            return None
        ab_old[kernel] = Path(src).resolve()
        args = args[2:]
    return ab_old


def kernel_wrappers() -> dict:
    """The wrappers of the SIMDRAM kernels by name, each with its launch
    counter."""
    from repro_torch.kernels.bitplane_transpose import from_planes, to_planes
    from repro_torch.kernels.bitserial_matmul import bitserial_matmul
    from repro_torch.kernels.uprog_executor import uprog_execute
    return {"uprog_execute": uprog_execute, "bitplane_to_planes": to_planes,
            "bitplane_from_planes": from_planes,
            "bitserial_matmul": bitserial_matmul}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    ab_old = parse_args(sys.argv[1:])
    if ab_old is None:
        print("usage: python3 chip_smoke.py [--ab-old [KERNEL=]OLD.cu ...] "
              f"(KERNEL one of {', '.join(AB_RUNS)})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    card = _smi("name,power.limit")
    print(f"card: {card}")
    device = "cuda"
    build_kernels()
    check_transpose(device, BANKS * LANES)
    check_fsm(device, BANKS, WORDS)
    check_uprogram_entry(device, BANKS, WORDS)
    check_bitserial(device)

    wrappers = kernel_wrappers()
    main_kernels = ("uprog_execute", "bitplane_to_planes",
                    "bitplane_from_planes")
    for w in wrappers.values():
        w.launches = 0
    path = main_path(device, BANKS, LANES)
    launches = {name: wrappers[name].launches for name in main_kernels}
    print(f"phase 4: main path OK in {path['seconds']:.2f} s "
          f"(drain makespan {path['makespan_ns']:.1f} modeled ns); "
          f"launches {launches}")
    print(path["report"])
    idle = [name for name, n in launches.items() if n == 0]
    _check(not idle, f"kernels not launched on the main path: {idle}")
    device_breakdown("main path",
                     lambda: main_path(device, BANKS, LANES)["seconds"])

    inputs = apps_inputs()
    app_launches = {}
    for backend in ("unrolled", None):
        label = backend or "kernel"
        for w in wrappers.values():
            w.launches = 0
        res = apps_path(device, backend, inputs)
        counts = {name: w.launches for name, w in wrappers.items()}
        print(f"phase 4b: applications path on the {label!r} backend OK in "
              f"{res['seconds']:.2f} s; μProgram Memory {res['cache']}; "
              f"launches {counts}")
        need = [name for name in wrappers
                if backend is None or name != "uprog_execute"]
        idle = [name for name in need if counts[name] == 0]
        _check(not idle, f"kernels not launched on the applications path "
               f"({label} backend): {idle}")
        if backend == "unrolled":
            _check(counts["uprog_execute"] == 0,
                   "the unrolled backend launched the FSM kernel")
        app_launches[label] = counts
    for backend in ("unrolled", None):
        device_breakdown(f"applications path ({backend or 'kernel'} backend)",
                         lambda b=backend: apps_path(device, b, inputs)[
                             "seconds"])
    del inputs

    for w in wrappers.values():
        w.launches = 0
    serve = serving_path(device)
    serve_launches = {name: wrappers[name].launches for name in wrappers}
    print(f"phase 4c: serving path OK, {SERVE_USERS} users x {SERVE_TOKENS} "
          f"tokens on 2 machines x {BANKS} banks in {serve['seconds']:.2f} s "
          f"of host wall time (the CPU run: {serve['cpu_seconds']:.2f} s); "
          f"launches {serve_launches}")
    print(serve["report"])
    idle = [name for name in main_kernels if serve_launches[name] == 0]
    _check(not idle, f"kernels not launched on the serving path: {idle}")
    device_breakdown("serving path", lambda: serving_run(device)[3])

    logits = sampler_logits()
    for w in wrappers.values():
        w.launches = 0
    sampler = sampler_path(device, logits)
    sampler_launches = {name: wrappers[name].launches for name in wrappers}
    warm = [sampler_call(sampler["machine"], logits)[2]
            for _ in range(SAMPLER_WARM_CALLS)]
    print(f"phase 4d: sampler OK at {SAMPLER_SHAPE}: 54 μPrograms, 3 "
          f"transposition passes, {sampler['exec_ns']:.1f} modeled ns of "
          f"execution ({sampler['total_ns']:.1f} ns in all) a call; host "
          f"wall time {sampler['cold_seconds']:.3f} s cold, warm "
          f"{' '.join(f'{t:.4f}' for t in warm)} s (CPU run "
          f"{sampler['cpu_seconds']:.2f} s); launches {sampler_launches}")
    idle = [name for name in main_kernels if sampler_launches[name] == 0]
    _check(not idle, f"kernels not launched by the sampler: {idle}")
    device_breakdown("sampler (one warm call)",
                     lambda: sampler_call(sampler["machine"], logits)[2])
    del logits, sampler

    # phase 5's timings run before 4e: after 4e's long profiles (~75,000
    # kernels each) the profiler's kernel times came out ~40 % below the
    # CUDA events' on the same calls
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    int_ops_per_s = sms * INT32_LANES_PER_SM * max_mhz * 1e6
    popc_per_s = sms * POPC_PER_SM * max_mhz * 1e6
    print(f"INT32 peak: {sms} SMs x {INT32_LANES_PER_SM} lanes x "
          f"{max_mhz:.0f} MHz = {int_ops_per_s / 1e12:.2f} Tops/s; popcount "
          f"peak {sms} x {POPC_PER_SM} x {max_mhz:.0f} MHz = "
          f"{popc_per_s / 1e12:.3f} T/s")
    kernels = measure(device, launches, int_ops_per_s)
    kernels += measure_bitserial(
        device, app_launches["unrolled"]["bitserial_matmul"], popc_per_s)

    lm = lm_serving_path(device, wrappers)
    lm_launches, cfg = lm["launches"], lm["cfg"]
    print(f"phase 4e: {cfg.name} at full width ({lm['params']:,} "
          f"parameters, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.compute_dtype} compute), {LM_BATCH} sequences x "
          f"{LM_PROMPT}-token prompt + {LM_NEW} new tokens")
    print(f"phase 4e (a): cached decode == no-cache forward at "
          f"{LM_CHECK_LAYERS} layers, float32, {LM_CHECK_STEPS} steps: max "
          f"|diff| {lm['decode_err']:.3e} (limit {LM_SELF_ABS}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    print_lm_serve("4e", lm, cfg)
    print(f"phase 4e (d): reduced {LM_ARCH} on the card vs the CPU: max "
          f"|diff| {lm['reduced_err'][0]:.4e} (limit "
          f"{lm['reduced_err'][1]:.4e}); greedy ids equal where the top-2 "
          "gap exceeds the limit")
    print(f"phase 4e (e): XNOR-popcount on the pum gate operands "
          f"({LM_BATCH * LM_PROMPT} x {cfg.d_model}) x ({cfg.d_model} x "
          f"{cfg.d_ff}) == the einsum of their signs")
    idle = [name for name in main_kernels if lm_launches[name] == 0]
    _check(not idle, f"kernels not launched on the LM serving path: {idle}")
    device_breakdown("LM serving, simdram sampler (one warm decode)",
                     lambda: lm_generate(lm["model"], cfg, lm["prompt"],
                                         "simdram", lm["machine"])[1])
    device_breakdown("LM serving, host sampler (one warm decode)",
                     lambda: lm_generate(lm["model"], cfg, lm["prompt"],
                                         "host")[1])
    host_breakdown("LM serving, host sampler (one warm decode)",
                   lambda: lm_generate(lm["model"], cfg, lm["prompt"],
                                       "host")[1], LM_NEW)
    del lm
    torch.cuda.empty_cache()

    moe = moe_serving_path(device, wrappers)
    moe_launches, cfg = moe["launches"], moe["cfg"]
    for arch, (err, peak) in moe["decode_err"].items():
        print(f"phase 4f (a): {arch} cached decode == no-cache forward at "
              f"full width, {dict(MOE_CHECKS)[arch] or 'all'} layers, "
              f"float32, {LM_CHECK_STEPS} steps: max |diff| {err:.3e} "
              f"(limit {LM_SELF_ABS}; peak {peak / 2**30:.2f} GiB allocated)")
    print(f"phase 4f: {cfg.name} at full width and depth "
          f"({moe['params']:,} parameters, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_experts} experts "
          f"top-{cfg.experts_per_tok}, d_expert {cfg.d_expert}, vocab "
          f"{cfg.vocab}, {cfg.compute_dtype} compute), {LM_BATCH} sequences "
          f"x {LM_PROMPT}-token prompt + {LM_NEW} new tokens; peak "
          f"{moe['build_peak'] / 2**30:.2f} GiB allocated after the build, "
          f"{moe['serve_peak'] / 2**30:.2f} GiB through the decodes")
    print_lm_serve("4f", moe, cfg)
    for arch, (err, tol) in moe["reduced_err"].items():
        print(f"phase 4f (d): reduced {arch} on the card vs the CPU: max "
              f"|diff| {err:.4e} (limit {tol:.4e})")
    idle = [name for name in main_kernels if moe_launches[name] == 0]
    _check(not idle, f"kernels not launched on the MoE serving path: {idle}")
    device_breakdown("MoE serving, simdram sampler (one warm decode)",
                     lambda: lm_generate(moe["model"], cfg, moe["prompt"],
                                         "simdram", moe["machine"])[1])
    device_breakdown("MoE serving, host sampler (one warm decode)",
                     lambda: lm_generate(moe["model"], cfg, moe["prompt"],
                                         "host")[1])
    print(f"phase 4f: {moe['seconds']:.1f} s before the profiled decodes")
    del moe
    torch.cuda.empty_cache()

    hybrid_launches = hybrid_encdec_path(device, wrappers, card)

    for w in wrappers.values():
        w.launches = 0
    train = training_path(device)
    train_launches = {name: w.launches for name, w in wrappers.items()}
    print_training(train, train_launches, card)
    _check(not any(train_launches.values()),
           f"a SIMDRAM kernel launched on the training path: {train_launches}")
    device_breakdown(f"training step, full width [{card}]",
                     lambda: one_train_step(train))
    host_breakdown("training step, full width",
                   lambda: one_train_step(train), 1)
    device_breakdown(f"AdamW update alone, full width [{card}]",
                     lambda: optimizer_step(train["state"], train["opt"]))
    del train
    torch.cuda.empty_cache()

    for w in wrappers.values():
        w.launches = 0
    distributed = distributed_path(device)
    # this process's launches and those of the ranks 4h (b) spawned
    dist_launches = {name: w.launches + distributed["rank_launches"][name]
                     for name, w in wrappers.items()}
    print_distributed(distributed, dist_launches, card)
    _check(not any(dist_launches.values()), "a SIMDRAM kernel launched on "
           f"the distributed path: {dist_launches}")
    del distributed
    torch.cuda.empty_cache()

    by_path = {"main": launches, "applications/unrolled":
               app_launches["unrolled"], "applications/kernel":
               app_launches["kernel"], "serving": serve_launches,
               "sampler": sampler_launches, "lm_serving": lm_launches,
               "lm_moe": moe_launches,
               "lm_hybrid": hybrid_launches["zamba2-7b"],
               "lm_encdec": hybrid_launches["whisper-large-v3"],
               "training": train_launches,
               "distributed": dist_launches}
    for row in kernels:
        wrapper = row["name"].split("/")[0]
        row["launches_by_path"] = {path: counts.get(wrapper, 0)
                                   for path, counts in by_path.items()}
        row["max_abs_err"] = MAX_ABS_ERR[wrapper]    # 4e's check (e) too
    if ab_old:
        ab = {kernel: AB_RUNS[kernel](device, build_old(src))
              for kernel, src in ab_old.items()}
        (ROOT / "chiprun_out" / "ab" / "ab.json").write_text(
            json.dumps(ab, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
