"""Batched serving example: prefill + greedy decode with KV caches (reduced
qwen config so it runs on the CPU in seconds), then the same decode with
the PuM-offloaded sampler metered by the timed execution layer — modeled
DRAM cost per decoded token.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise; on a CUDA device the
sampler runs the FSM and transposition kernels.
"""
import argparse
import sys

import torch

from repro_torch.configs import get_reduced
from repro_torch.models.params import init_params
from repro_torch.models.transformer import Transformer, model_defs
from repro_torch.ops import PerfStats, SimdramMachine
from repro_torch.serve.decode import greedy_decode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_decode",
        description="prefill + greedy decode of a reduced qwen1.5-0.5b, "
                    "host and in-DRAM samplers")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the sampler run (default: "
                         "%(default)s)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = get_reduced("qwen1.5-0.5b")
    gen = torch.Generator(device=device)
    params = init_params(model_defs(cfg), gen.manual_seed(0), device=device)
    model = Transformer(cfg, device=device).load_params(params)
    batch, prompt_len, steps = 4, 12, 16
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=gen.manual_seed(1), device=device)
    out = greedy_decode(model, cfg, prompts, steps=steps,
                        max_seq=prompt_len + steps)
    print(f"arch={cfg.name}  batch={batch}  prompt={prompt_len}  "
          f"generated={steps}  device={device}")
    for i in range(batch):
        print(f"  seq{i}: prompt={prompts[i].tolist()} "
              f"-> {out[i].tolist()}")
    assert out.shape == (batch, steps)
    print("decode OK (greedy, KV-cached)")

    # same decode, sampling in-memory: each sequence's quantized logits in
    # its own DRAM bank, metered by the timed execution layer
    stats = PerfStats()
    out_pum = greedy_decode(model, cfg, prompts, steps=steps,
                            max_seq=prompt_len + steps, sampler="simdram",
                            sampler_perf=stats,
                            machine=SimdramMachine(device=device,
                                                   banks=batch))
    assert out_pum.shape == (batch, steps)
    print(f"PuM sampler OK: modeled {stats.total_ns / steps:.0f} ns "
          f"/ {stats.total_nj / steps:.0f} nJ per decoded token "
          f"({stats.n_programs // steps} μPrograms/token, "
          f"banks={stats.max_banks})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
