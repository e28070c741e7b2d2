"""simbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell with ``python3 simbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; see ``simbench/README.md``.
"""
