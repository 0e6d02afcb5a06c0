"""The port's ``solve`` with annealing refinement at the JAX test's budget
(tests/test_solve.py:41: ta01, batch 256, 2 sweeps, 600 iterations): within
8% of the optimum 1231, and the artifact replays to its makespan. Its own
file, so that the test runner's workers spread it from the other solver
tests."""

import torch

from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import replay as tr
from jssenv_tpu_torch import solve as tsv

torch.set_num_threads(1)


def test_solve_with_refine_gap_bound_ta01():
    spec = ti.get_instance("ta01")
    res = tsv.solve(spec, batch=256, sweeps=2, seed=0, refine_iters=600, device="cpu")
    assert res.makespan <= 1231 * 1.08
    makespan, _ = tr.replay_machine_order(spec, res.machine_order(), device="cpu")
    assert makespan == res.makespan
