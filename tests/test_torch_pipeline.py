"""The GPipe pipeline (``repro_torch.distributed.pipeline``) on 4 gloo
ranks against the sequential composition of its stages, forward and
gradients, at the reference test's shapes (P 4; M 6 × mb 8 × d 16
forward, M 4 × mb 4 × d 8 gradients) and at M < P and M = 1.

The reference's own pipeline tests fail on the installed jax (its
``pipeline_apply`` raises ``ShardingTypeError``), so the port is held to
the composition those tests compare with.  Tolerances: forward 1e-5,
gradients 1e-4 (absolute), as the reference's tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import (pipeline_apply,
                                              stack_stage_params)
from repro_torch.launch.mesh import make_mesh, spawn_ranks

P = 4
# (M, mb, d, with gradients)
CASES = {"forward": (6, 8, 16, False), "grad": (4, 4, 8, True),
         "m_below_p": (2, 4, 8, True), "m1": (1, 4, 8, True)}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def case_inputs(name: str):
    m, mb, d, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    ws = [torch.from_numpy((rng.standard_normal((d, d)) * 0.3)
                           .astype(np.float32)) for _ in range(P)]
    x = torch.from_numpy(rng.standard_normal((m, mb, d)).astype(np.float32))
    return ws, x


def sequential(ws, x, grad: bool):
    ws = [w.clone().requires_grad_(grad) for w in ws]
    h = x
    for w in ws:
        h = stage_fn({"w": w}, h)
    g = None
    if grad:
        (h ** 2).sum().backward()
        g = torch.stack([w.grad for w in ws])
    return h.detach(), g


def pipeline_rank(rank: int, world: int, out_dir: str) -> None:
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = make_mesh((world,), ("pipe",), "cpu")
    for name, (m, _, _, grad) in CASES.items():
        ws, x = case_inputs(name)
        w = distribute_tensor(stack_stage_params([{"w": w} for w in ws])["w"],
                              mesh, [Shard(0)], src_data_rank=None)
        w.requires_grad_(grad)
        y = pipeline_apply(stage_fn, {"w": w}, x, mesh=mesh, axis="pipe")
        out = {"y": y.detach().numpy()}
        if grad:
            (y ** 2).sum().backward()
            out["g"] = w.grad.full_tensor().numpy()
            out["local"] = np.array(w.to_local().shape)
        np.savez(f"{out_dir}/{name}_{rank}.npz", **out)


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    spawn_ranks(pipeline_rank, P, (str(out),), timeout=240)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_the_sequential_composition(pipeline_runs, name):
    m, mb, d, grad = CASES[name]
    ws, x = case_inputs(name)
    want_y, want_g = sequential(ws, x, grad)
    runs = [np.load(pipeline_runs / f"{name}_{r}.npz") for r in range(P)]
    # the last stage's buffer holds the outputs, every other stage's zeros
    np.testing.assert_allclose(runs[-1]["y"], want_y.numpy(), rtol=0,
                               atol=1e-5)
    for r in range(P - 1):
        assert not runs[r]["y"].any()
    if grad:
        for run in runs:
            assert tuple(run["local"]) == (1, d, d)   # its stage's weights
            np.testing.assert_allclose(run["g"], want_g.numpy(), rtol=0,
                                       atol=1e-4)
