"""The port's ``solve``: its greedy lanes and seeding bit for bit against the
JAX package, its noisy search by the JAX tests' properties
(tests/test_solve.py)."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from jssenv_tpu import anneal as ja  # noqa: E402
from jssenv_tpu import instances as ji  # noqa: E402
from jssenv_tpu import solve as js  # noqa: E402
from jssenv_tpu import vector as jv  # noqa: E402

from jssenv_tpu_torch import anneal as ta  # noqa: E402
from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import replay as tr  # noqa: E402
from jssenv_tpu_torch import solve as tsv  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import engine as te  # noqa: E402
from jssenv_tpu_torch.rules import dispatching as td  # noqa: E402

torch.set_num_threads(1)
NUM_RULES = 5

with open(os.path.join(os.path.dirname(__file__), "data", "golden_solutions.json")) as f:
    TA01 = np.array(json.load(f)["ta01"]["machine_order"], np.int32)


@pytest.fixture(scope="module")
def greedy_ta01():
    """Each portfolio rule's greedy makespan on ta01, as the port's rules
    (held against the JAX package's in tests/test_torch_dispatching.py)
    give them."""
    got = td.compare_rules_batched(ti.get_instance("ta01"), num_episodes=1, explore_prob=0.0, device="cpu")
    return {k: int(v["avg_makespan"]) for k, v in got.items()}


def test_greedy_lanes_equal_jax():
    """``_solve_scan``'s first ``num_rules`` lanes run at temperature 0: their
    best makespans and schedules equal the JAX package's lane for lane,
    whatever the noise of the other lanes."""
    B, steps = 8, 15 * 15 + 8
    state = tv.make_batch(ti.get_instance("ta01"), B, device="cpu")
    mk, sol, eps = tsv._solve_scan(state, torch.Generator().manual_seed(0), steps, 0.7, NUM_RULES)
    jmk, jsol, jeps = js._solve_scan(jv.make_batch(ji.get_instance("ta01"), B), jnp.uint32(1), steps, 0.7,
                                     NUM_RULES)
    assert mk.dtype == sol.dtype == torch.int32
    np.testing.assert_array_equal(mk[:NUM_RULES].numpy(), np.asarray(jmk)[:NUM_RULES])
    np.testing.assert_array_equal(sol[:NUM_RULES].numpy(), np.asarray(jsol)[:NUM_RULES])
    assert int(eps) == int(jeps) == B  # every lane finished once


def test_solve_beats_or_matches_greedy_rules(greedy_ta01):
    spec = ti.get_instance("ta01")
    res = tsv.solve(spec, batch=64, sweeps=2, temperature=0.7, seed=0, device="cpu")
    assert res.makespan <= min(greedy_ta01.values())
    assert res.episodes >= 64  # every lane finished at least one episode
    assert res.solution.min() >= 0 and res.solution.shape == (15, 15)
    assert set(res.timings) == {"rollout_s"}


def test_solve_zero_temperature_equals_best_portfolio_rule(greedy_ta01):
    res = tsv.solve(ti.get_instance("ta01"), batch=8, sweeps=1, temperature=0.0, num_rules=NUM_RULES, seed=1,
                    device="cpu")
    assert res.makespan == min(greedy_ta01[n] for n in ("SPT", "MWR", "MOR", "FIFO", "CR")) == 1426


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_solution_replays_to_claimed_makespan(backend):
    spec = ti.get_instance("ta01")
    res = tsv.solve(spec, batch=32, sweeps=2, temperature=0.7, seed=2, device="cpu")
    makespan, state = tr.replay_machine_order(spec, res.machine_order(), backend=backend, device="cpu")
    assert makespan == res.makespan
    sol = state.solution[0].numpy() if backend == "torch" else state.solution
    assert (sol[: spec.num_jobs, : spec.num_machines] == res.solution).all()


def test_top_k_distinct_orders_equal_jax():
    """Duplicates collapse to one entry, infeasible lanes never seed, a short
    set tiles round-robin, best first; the same lanes as the JAX package."""
    s = te.state_from_spec(ti.get_instance("ta01"), device="cpu")
    t = ta.schedule_tables(s.op_machine[0], s.op_dur[0], s.op_pos[0], device="cpu")
    worse = TA01.copy()
    worse[0] = np.roll(worse[0], 1)  # a different, infeasible order
    swapped = TA01.copy()
    swapped[3, [4, 5]] = swapped[3, [5, 4]]
    orders = torch.from_numpy(np.stack([TA01, swapped, TA01, worse, swapped, TA01]))
    mks = ta.evaluate_orders(t, orders)
    assert int(mks[3]) == np.iinfo(np.int32).max
    for k in (1, 2, 4, 7):
        got = tsv.top_k_distinct_orders(orders, mks, k)
        want = js.top_k_distinct_orders(jnp.asarray(orders.numpy()), jnp.asarray(mks.numpy()), k)
        assert got.dtype == torch.int32 and got.shape == (k, 15, 15)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got[0].numpy() == TA01).all()
        assert (ta.evaluate_orders(t, got) < np.iinfo(np.int32).max).all()
    with pytest.raises(RuntimeError, match="no feasible"):
        tsv.top_k_distinct_orders(orders[3:4], mks[3:4], 2)


def test_refine_seeds_equal_jax():
    """What ``_refine`` hands the searches: ``orders_from_solutions`` of the
    rollout lanes' best schedules and their makespans, equal to the JAX
    package's on the same schedules."""
    spec = ti.get_instance("ta01")
    state = tv.make_batch(spec, 16, device="cpu")
    mk, sol, _ = tsv._solve_scan(state, torch.Generator().manual_seed(3), 15 * 15 * 2 + 8, 0.7, NUM_RULES)
    t = ta.schedule_tables(state.op_machine[0], state.op_dur[0], state.op_pos[0], device="cpu")
    orders = ta.orders_from_solutions(state.op_pos[0], sol)
    jt = tuple(jnp.asarray(x.numpy()) for x in t)
    jorders = ja.orders_from_solutions(jnp.asarray(state.op_pos[0].numpy()), jnp.asarray(sol.numpy()))
    np.testing.assert_array_equal(orders.numpy(), np.asarray(jorders))
    # a rollout schedule's DAG makespan is at most its env makespan
    got = ta.evaluate_orders(t, orders)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja.evaluate_orders(jt, jorders)))
    assert bool((got <= mk).all())


def test_refine_certifies_through_replay():
    """``_refine`` keeps the rollout result unless the certified (replayed)
    makespan is better, and then returns the replayed schedule with its
    stage timings."""
    spec = ti.get_instance("ta01")
    base = tsv.solve(spec, batch=16, sweeps=1, seed=4, device="cpu")
    res = tsv.solve(spec, batch=16, sweeps=1, seed=4, refine_iters=200, device="cpu")
    assert res.makespan < base.makespan and res.episodes == base.episodes
    assert set(res.timings) == {"rollout_s", "refine_s", "certify_s"}
    assert all(v >= 0 for v in res.timings.values())
    mk, final = tr.replay_machine_order(spec, res.machine_order(), backend="native")
    assert mk == res.makespan and (final.solution == res.solution).all()


def test_solve_refuses_a_multi_instance_set():
    with pytest.raises(ValueError, match="one instance"):
        tsv.solve(ti.get_instance_set(["ta01", "ta02"]), batch=4, device="cpu")
