"""The modeled-DRAM meters a SIMDRAM machine should read after a stream of
bbops, from a table of each operation's μProgram cost.

The table (``dram_cost/<config>-<n>b.json``) holds, for every operation at
``n`` bits, its command mix (AAP, AP, TRA) and the modeled latency and
energy of one execution at the configuration's timing.  One bbop executes
its μProgram once over ``banks`` banks in lockstep: the latency is charged
once, the energy once a bank, ``banks × lanes`` element operations, and
its AAP and AP commands.  The meters are summed in the order the ops were
issued, from zero, so a float sum equals the machine's own accumulation
bit for bit when every charge is right.
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def table(config: str, n_bits: int) -> dict:
    """operation → {AAP, AP, TRA, latency_ns, energy_nj}."""
    with open(HERE / "dram_cost" / f"{config}-{n_bits}b.json") as f:
        return json.load(f)["ops"]


def meters(costs: dict, issued, banks: int, lanes: int) -> dict:
    """exec_ns, exec_nj, elem_ops and n_commands after the operations
    ``issued`` (names, in order) on ``banks`` × ``lanes`` elements."""
    exec_ns = exec_nj = 0.0
    elem_ops = n_commands = 0
    for op in issued:
        c = costs[op]
        exec_ns += c["latency_ns"]
        exec_nj += c["energy_nj"] * banks
        elem_ops += lanes * banks
        n_commands += c["AAP"] + c["AP"]
    return {"exec_ns": exec_ns, "exec_nj": exec_nj, "elem_ops": elem_ops,
            "n_commands": n_commands}
