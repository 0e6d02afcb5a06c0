"""The port's tabu search in its three neighborhoods ("sampled", "full",
"guided"), held by the JAX tests' properties (tests/test_anneal.py): a
seeded optimum holds, rule schedules improve and the refined result replays
to its makespan, and the best makespan is always the exact DAG makespan of
the best order (the estimates only steer the selection). The draws come
from a ``torch.Generator``, so the chains are not the JAX package's; the
estimates and the evaluator they rest on are held bit for bit in
tests/test_torch_anneal.py."""

import json
import os

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import anneal as ta
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import replay as tr
from jssenv_tpu_torch import solve as tsv
from jssenv_tpu_torch.core import engine as te

torch.set_num_threads(1)
NEIGHBORHOODS = ("sampled", "full", "guided")

with open(os.path.join(os.path.dirname(__file__), "data", "golden_solutions.json")) as f:
    TA01 = np.array(json.load(f)["ta01"]["machine_order"], np.int32)


def _tables(spec):
    s = te.state_from_spec(spec, device="cpu")
    return ta.schedule_tables(s.op_machine[0], s.op_dur[0], s.op_pos[0], device="cpu"), s.op_pos[0]


@pytest.mark.parametrize("neighborhood", NEIGHBORHOODS)
def test_tabu_from_optimum_stays_at_optimum(neighborhood):
    """Tabu moves go uphill, but best-so-far tracking holds a seeded optimum."""
    t, _ = _tables(ti.get_instance("ta01"))
    orders = torch.from_numpy(TA01)[None].repeat(4, 1, 1)
    best_orders, best = ta.tabu_search(t, orders, 0, 60, proposals=4, neighborhood=neighborhood)
    assert best.dtype == best_orders.dtype == torch.int32
    assert best.tolist() == [1231] * 4
    assert torch.equal(ta.evaluate_orders(t, best_orders), best)


@pytest.mark.parametrize("neighborhood", NEIGHBORHOODS)
def test_tabu_improves_and_is_exact_on_best(neighborhood):
    """From rollout schedules of a random 10x6 instance: the best improves
    on the seeds, and ``best_mk`` is the exact makespan of ``best_orders``."""
    spec = ti.random_instance(10, 6, duration_range=(1, 30), seed=11)
    t, pos = _tables(spec)
    sol = tsv.solve(spec, batch=32, sweeps=2, seed=2, device="cpu")
    orders0 = ta.orders_from_solutions(pos, torch.from_numpy(sol.solution)[None].repeat(8, 1, 1))
    seed_mk = int(ta.evaluate_orders(t, orders0)[0])
    bo, bmk = ta.tabu_search(t, orders0, 5, iters=120, proposals=4, neighborhood=neighborhood)
    assert int(bmk.min()) <= sol.makespan and int(bmk.min()) < seed_mk
    assert torch.equal(ta.evaluate_orders(t, bo), bmk)


@pytest.mark.parametrize("neighborhood", NEIGHBORHOODS)
def test_tabu_refinement_improves_and_certifies(neighborhood):
    """solve(refine_method="tabu"): no worse than the rollout result, and the
    returned artifact replays to its claimed makespan."""
    spec = ti.random_instance(10, 6, duration_range=(1, 30), seed=7)
    base = tsv.solve(spec, batch=64, sweeps=2, seed=3, device="cpu")
    refined = tsv.solve(spec, batch=64, sweeps=2, seed=3, refine_iters=150, refine_method="tabu",
                        tabu_chains=16, tabu_proposals=4, tabu_neighborhood=neighborhood, device="cpu")
    assert refined.makespan <= base.makespan
    mk, _ = tr.replay_machine_order(spec, refined.machine_order(), device="cpu")
    assert mk == refined.makespan


def test_guided_proposals_beyond_the_candidate_set_raise():
    """Gumbel-top-P draws P distinct (machine, rank) pairs, so P > M*J has
    no meaning (the JAX package's ``lax.top_k`` fails there); the port
    refuses it up front, with the bound in the message."""
    spec = ti.random_instance(4, 3, seed=0)
    t, pos = _tables(spec)
    orders = torch.arange(4, dtype=torch.int32).expand(2, 3, 4).contiguous()
    with pytest.raises(ValueError, match="proposals <= 12"):
        ta.tabu_search(t, orders, 0, 5, proposals=13, neighborhood="guided")
    with pytest.raises(ValueError, match="proposals <= 12"):
        tsv.solve(spec, batch=8, sweeps=1, refine_iters=5, refine_method="tabu", tabu_chains=2,
                  tabu_proposals=13, tabu_neighborhood="guided", device="cpu")
    bo, bmk = ta.tabu_search(t, orders, 0, 5, proposals=12, neighborhood="guided")
    assert torch.equal(ta.evaluate_orders(t, bo), bmk)
    with pytest.raises(ValueError, match="neighborhood"):
        ta.tabu_search(t, orders, 0, 5, neighborhood="greedy")
    with pytest.raises(ValueError, match="refine_method"):
        tsv.solve(spec, batch=8, sweeps=1, refine_iters=5, refine_method="ga", device="cpu")


def test_tabu_keeps_infeasible_per_lane_seeds_in_place():
    """With per-lane tables a lane with an infeasible seed stays at
    INT32_MAX and never moves (it cannot borrow another instance's order);
    with shared tables it restarts from the best lane."""
    spec = ti.get_instance("ta01")
    t, _ = _tables(spec)
    good = torch.from_numpy(TA01)
    bad = good.clone()
    bad[0] = bad[0].flip(0)
    orders = torch.stack([good, bad])
    bt = tuple(x[None].repeat(2, 1, 1) for x in t)
    bo, bmk = ta.tabu_search(bt, orders, 1, 10, proposals=2)
    assert bmk.tolist() == [1231, np.iinfo(np.int32).max] and torch.equal(bo[1], bad)
    bo, bmk = ta.tabu_search(t, orders, 1, 10, proposals=2)
    assert bmk.tolist() == [1231, 1231]


@pytest.mark.parametrize("search", ["anneal", "sampled", "full", "guided"])
def test_chunks_change_nothing(search):
    """A run split into chunks (``_anneal_chunk`` / ``_tabu_chunk`` /
    ``_tabu_chunk_full`` on the carry of ``_anneal_init`` / ``_tabu_init``)
    ends where the single call ends: the temperature, the restarts and the
    tabu tenures follow the global iteration."""
    spec = ti.random_instance(10, 6, duration_range=(1, 30), seed=5)
    t, pos = _tables(spec)
    sol = tsv.solve(spec, batch=16, sweeps=1, seed=1, device="cpu")
    orders0 = ta.orders_from_solutions(pos, torch.from_numpy(sol.solution)[None].repeat(6, 1, 1))
    iters, cut = 260, 97  # across the restart at iteration 249
    if search == "anneal":
        want = ta.anneal(t, orders0, 3, iters)
        carry = ta._anneal_init(t, orders0, 3)
        for i0, n in ((0, cut), (cut, iters - cut)):
            carry = ta._anneal_chunk(t, carry, i0, n, iters, 0.08, 0.004, 0.05)
        got = carry[2][:2]
    else:
        want = ta.tabu_search(t, orders0, 3, iters, proposals=4, neighborhood=search)
        carry = ta._tabu_init(t, orders0, 3)
        for i0, n in ((0, cut), (cut, iters - cut)):
            if search == "full":
                carry = ta._tabu_chunk_full(t, carry, i0, n, 8, 6)
            else:
                carry = ta._tabu_chunk(t, carry, i0, n, 4, 8, 6, 4.0 if search == "guided" else None)
        got = carry[3]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
