"""The port's order-space evaluator and annealer against the JAX package's.

Bit-exact on the CPU, on the same numpy orders: ``_sweep``'s makespans and
starts on the published optima, on infeasible orders, on feasible orders of
random-legal episodes (``orders_from_solutions``) and on random permutations
(mostly infeasible); the tails, critical pairs, block bounds, neighbor
bounds, swap estimates and the two moves on those orders; per-lane tables
against shared ones. The annealer draws from a ``torch.Generator``, so it is
held by the JAX tests' properties (tests/test_anneal.py): it holds a seeded
optimum, improves rule schedules and certifies them; and the move set's
theorem (non-critical swaps never improve) and the neighbor bounds hold
against brute force."""

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
from jssenv_tpu.core import engine as je  # noqa: E402

from jssenv_tpu_torch import anneal as ta  # noqa: E402
from jssenv_tpu_torch import instances as ti  # noqa: E402
from jssenv_tpu_torch import replay as tr  # noqa: E402
from jssenv_tpu_torch import solve as tsv  # noqa: E402
from jssenv_tpu_torch import vector as tv  # noqa: E402
from jssenv_tpu_torch.core import engine as te  # noqa: E402

torch.set_num_threads(1)
I32_MAX = np.iinfo(np.int32).max

with open(os.path.join(os.path.dirname(__file__), "data", "golden_solutions.json")) as f:
    GOLDEN = json.load(f)
OPTIMA = sorted(k for k, v in GOLDEN.items() if "optimum" in v)


def _spec(name):
    return ti.random_instance(6, 5, (1, 9), seed=3) if name == "rand6x5" else ti.get_instance(name)


def _tables(spec):
    """(port tables, JAX tables) of one instance, from the port's state."""
    s = te.state_from_spec(spec, device="cpu")
    t = ta.schedule_tables(s.op_machine[0], s.op_dur[0], s.op_pos[0], device="cpu")
    return t, tuple(jnp.asarray(x.numpy()) for x in t), s


def _golden(name):
    return np.array(GOLDEN[name]["machine_order"], np.int32)[None]


def _episode_orders(spec, B, seed):
    """(B, M, J) feasible orders: the solutions of random-legal episodes."""
    s = tv.make_batch(spec, B, device="cpu")
    g = torch.Generator().manual_seed(seed)
    final, ms, _ = tv.episode_makespans(g, s, spec.num_jobs * spec.num_machines * 3)
    assert bool((ms > 0).all())
    return ta.orders_from_solutions(s.op_pos[0], final.solution), ms


def test_schedule_tables_equal_jax():
    spec = ti.get_instance("ta41")
    t, _, s = _tables(spec)
    js = je.state_from_spec(ji.get_instance("ta41"))
    for got, want in zip(t, ja.schedule_tables(js.op_machine, js.op_dur, js.op_pos)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(ta.reverse_tables(t), ja.reverse_tables(ja.schedule_tables(js.op_machine, js.op_dur,
                                                                                     js.op_pos))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", OPTIMA)
def test_evaluator_reproduces_published_optima(name):
    """The DAG longest path of a published-optimal order is its optimum;
    makespans and starts equal the JAX package's."""
    t, jt, _ = _tables(ti.get_instance(name))
    mk, starts = ta._sweep(t, torch.from_numpy(_golden(name)))
    assert mk.dtype == starts.dtype == torch.int32
    assert int(mk[0]) == GOLDEN[name]["optimum"]
    if name in ("ta01", "ta41", "ta51"):
        jmk, jstarts = ja._sweep(jt, jnp.asarray(_golden(name)))
        np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))


def test_evaluator_flags_infeasible_orders():
    t, jt, _ = _tables(ti.get_instance("ta01"))
    order = _golden("ta01")[0]
    bad = order.copy()
    bad[0] = bad[0][::-1]  # reversing one machine's order creates cycles
    both = np.stack([order, bad])
    mks = ta.evaluate_orders(t, torch.from_numpy(both))
    assert mks.tolist() == [1231, I32_MAX]
    np.testing.assert_array_equal(mks.numpy(), np.asarray(ja.evaluate_orders(jt, jnp.asarray(both))))


def _cases(name):
    """Feasible episode orders, their adjacent-swap neighbors (some
    infeasible), and random permutations (mostly infeasible)."""
    spec = _spec(name)
    feas, _ = _episode_orders(spec, 24, seed=len(name))
    rng = np.random.default_rng(len(name))
    B, M, J = feas.shape
    msel = torch.from_numpy(rng.integers(0, M, B).astype(np.int32))
    p = torch.from_numpy(rng.integers(0, J - 1, B).astype(np.int32))
    swapped = ta._swap_adjacent(feas, msel, p)
    perms = torch.from_numpy(np.stack([rng.permutation(J) for _ in range(8 * M)]).reshape(8, M, J).astype(np.int32))
    return spec, torch.cat([feas, swapped, perms]), (feas, msel, p)


@pytest.mark.parametrize("name", ["ta01", "rand6x5", "ta41"])
def test_evaluator_and_criticality_equal_jax(name):
    spec, orders, (feas, msel, p) = _cases(name)
    t, jt, _ = _tables(spec)
    jo = jnp.asarray(orders.numpy())
    mk, starts = ta._sweep(t, orders)
    jmk, jstarts = ja._sweep(jt, jo)
    np.testing.assert_array_equal(mk.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    assert (mk[:24] < I32_MAX).all() and (mk == I32_MAX).any()
    rt, jrt = ta.reverse_tables(t), ja.reverse_tables(jt)
    tails = ta._tails(rt, orders)
    jtails = ja._tails(jrt, jo)
    np.testing.assert_array_equal(tails.numpy(), np.asarray(jtails))
    np.testing.assert_array_equal(ta.critical_pairs(t, rt, orders, mk, starts).numpy(),
                                  np.asarray(ja.critical_pairs(jt, jrt, jo, jmk, jstarts)))
    crit = ta._critical_ops(t, orders, mk, starts, tails)
    jcrit = ja._critical_ops(jt, jo, jmk, jstarts, jtails)
    np.testing.assert_array_equal(crit.numpy(), np.asarray(jcrit))
    for got, want in zip(ta._block_bounds(crit), ja._block_bounds(jcrit)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dur_rank = ta._dur_rank(t, orders)
    jd = jnp.asarray(dur_rank.numpy())
    for got, want in zip(ta._neighbor_bounds(t, orders, starts, tails, dur_rank),
                         ja._neighbor_bounds(jt, jo, jstarts, jtails, jd)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ta._swap_estimates(t, orders, starts, tails, dur_rank).numpy(),
                                  np.asarray(ja._swap_estimates(jt, jo, jstarts, jtails, jd)))
    # the moves, on the same arguments
    jf = jnp.asarray(feas.numpy())
    np.testing.assert_array_equal(ta._swap_adjacent(feas, msel, p).numpy(),
                                  np.asarray(ja._swap_adjacent(jf, jnp.asarray(msel.numpy()), jnp.asarray(p.numpy()))))
    rng = np.random.default_rng(7)
    J = feas.shape[2]
    a = rng.integers(0, J, feas.shape[0])
    b = rng.integers(0, J, feas.shape[0])
    lo, hi = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)
    front = rng.random(feas.shape[0]) < 0.5
    got = ta._move_insert(feas, msel, torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(front))
    want = ja._move_insert(jf, jnp.asarray(msel.numpy()), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(front))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pad", [False, True])
def test_orders_from_solutions_equal_jax(pad):
    """Stable ties and -1 padding (unfinished lanes) resolve by the lowest
    job index, on shared and per-lane op positions."""
    spec = ti.get_instance("ta01")
    s = tv.make_batch(spec, 12, device="cpu")
    g = torch.Generator().manual_seed(4)
    final, _, _ = tv.episode_makespans(g, s, 100 if pad else 700)  # 100 steps: partial schedules
    sol = final.solution
    pos = s.op_pos if pad else s.op_pos[0]
    got = ta.orders_from_solutions(pos, sol)
    want = ja.orders_from_solutions(jnp.asarray(pos.numpy()), jnp.asarray(sol.numpy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pad == bool((sol < 0).any())


def test_batched_tables_match_shared_tables():
    """Per-lane (B, J, M) tables: lanes of different instances in one sweep
    equal per-instance evaluation with shared tables, and the JAX package's
    batched evaluation; tabu over the mixed batch improves or holds every
    instance, and each instance's best replays to at least its DAG
    makespan. (Not always to it: the env's legality rules can hold an op
    past its semi-active start. On ta03 this run's best order evaluates to
    1568 in both packages and replays to 1588 in both; the JAX test's
    equality at tests/test_anneal.py:201 holds for its own draws.)"""
    names = ["ta01", "ta02", "ta03"]
    shared, orders = {}, {}
    for name in names:
        t, _, _ = _tables(ti.get_instance(name))
        shared[name] = t
        orders[name], _ = _episode_orders(ti.get_instance(name), 2, seed=1)
    stacked = torch.cat([orders[n] for n in names])
    btables = tuple(torch.cat([shared[n][i][None].repeat(2, 1, 1) for n in names]) for i in range(3))
    mk_b, starts_b = ta._sweep(btables, stacked)
    jb = tuple(jnp.asarray(x.numpy()) for x in btables)
    jmk, jstarts = ja._sweep(jb, jnp.asarray(stacked.numpy()))
    np.testing.assert_array_equal(mk_b.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(starts_b.numpy(), np.asarray(jstarts))
    cp_b = ta.critical_pairs(btables, ta.reverse_tables(btables), stacked, mk_b, starts_b)
    for k, name in enumerate(names):
        lanes = slice(2 * k, 2 * k + 2)
        mk_s, starts_s = ta._sweep(shared[name], orders[name])
        assert torch.equal(mk_b[lanes], mk_s) and torch.equal(starts_b[lanes], starts_s)
        cp_s = ta.critical_pairs(shared[name], ta.reverse_tables(shared[name]), orders[name], mk_s, starts_s)
        assert torch.equal(cp_b[lanes], cp_s)
    bo, bmk = ta.tabu_search(btables, stacked, 3, iters=60, proposals=4)
    for k, name in enumerate(names):
        lanes = slice(2 * k, 2 * k + 2)
        assert int(bmk[lanes].min()) <= int(mk_b[lanes].min())
        lane = 2 * k + int(torch.argmin(bmk[lanes]))
        mk_cert, _ = tr.replay_machine_order(ti.get_instance(name), bo[lane].tolist(), backend="auto")
        assert mk_cert >= int(bmk[lane])


def test_anneal_from_optimum_stays_at_optimum():
    t, _, _ = _tables(ti.get_instance("ta01"))
    orders = torch.from_numpy(_golden("ta01")).repeat(4, 1, 1)
    best_orders, best = ta.anneal(t, orders, 0, 100)
    assert best.dtype == best_orders.dtype == torch.int32
    assert best.tolist() == [1231] * 4


def test_anneal_improves_rule_schedules_and_certifies():
    """End to end: rollout search + annealing refinement, certified replay."""
    spec = ti.get_instance("ta01")
    base = tsv.solve(spec, batch=32, sweeps=2, temperature=0.7, seed=5, device="cpu")
    refined = tsv.solve(spec, batch=32, sweeps=2, temperature=0.7, seed=5, refine_iters=400, device="cpu")
    assert refined.makespan <= base.makespan
    assert set(refined.timings) == {"rollout_s", "refine_s", "certify_s"} or refined.makespan == base.makespan
    mk, _ = tr.replay_machine_order(spec, refined.machine_order(), device="cpu")
    assert mk == refined.makespan


def test_anneal_insertion_moves_and_stale_tails():
    """``p_insert`` (block insertions, which may be infeasible) and
    ``tails_refresh`` change the search, never the exactness of its best."""
    spec = ti.random_instance(10, 6, (1, 30), seed=7)
    t, _, _ = _tables(spec)
    orders, ms = _episode_orders(spec, 8, seed=2)
    bo, bmk = ta.anneal(t, orders, 1, 150, p_insert=0.4, tails_refresh=4)
    assert torch.equal(ta.evaluate_orders(t, bo), bmk)
    assert bool((bmk <= ms).all()) and int(bmk.min()) < int(ms.min())


def test_noncritical_adjacent_swaps_never_improve():
    """The theorem behind the move set: an adjacent swap can only reduce
    the makespan if both ops are critical. Every adjacent swap of small
    random instances, enumerated."""
    for seed in range(3):
        spec = ti.random_instance(5, 4, seed=seed)
        t, _, _ = _tables(spec)
        rt = ta.reverse_tables(t)
        J, M = 5, 4
        orders = torch.arange(J, dtype=torch.int32).expand(1, M, J).contiguous()
        mk, starts = ta._sweep(t, orders)
        assert int(mk[0]) < I32_MAX
        cand = ta.critical_pairs(t, rt, orders, mk, starts)[0]
        tails = ta._tails(rt, orders)
        crit = ((starts + ta._dur_rank(t, orders) + tails) == int(mk[0]))[0]
        assert crit.any()
        where = [(m, r) for m in range(M) for r in range(J - 1)]
        props = torch.cat([ta._swap_adjacent(orders, torch.tensor([m], dtype=torch.int32),
                                             torch.tensor([r], dtype=torch.int32)) for m, r in where])
        for (m, r), mk_p in zip(where, ta.evaluate_orders(t, props).tolist()):
            if mk_p < int(mk[0]):
                assert crit[m, r] and crit[m, r + 1], f"non-critical swap ({m},{r}) improved {int(mk[0])}->{mk_p}"
        expect = crit[:, :-1] & crit[:, 1:]
        assert torch.equal(cand[:, :-1], expect) and not cand[:, -1].any()


def test_neighbor_bounds_match_bruteforce():
    """JPend / JStail in rank layout against a direct recomputation from the
    schedule and the instance data."""
    for seed in (0, 1):
        spec = ti.random_instance(6, 5, duration_range=(1, 20), seed=seed)
        t, _, _ = _tables(spec)
        sol = tsv.solve(spec, batch=8, sweeps=1, seed=seed, device="cpu")
        pos = te.state_from_spec(spec, device="cpu").op_pos[0]
        orders = ta.orders_from_solutions(pos, torch.from_numpy(sol.solution)[None])
        mk, starts = ta._sweep(t, orders)
        tails = ta._tails(ta.reverse_tables(t), orders)
        JP, JS = ta._neighbor_bounds(t, orders, starts, tails, ta._dur_rank(t, orders))
        J, M = spec.num_jobs, spec.num_machines
        om, od = np.asarray(spec.op_machine), np.asarray(spec.op_dur)
        o, st, tl_ = orders[0].numpy(), starts[0].numpy(), tails[0].numpy()
        start_jm, tail_jm = np.zeros((J, M), np.int64), np.zeros((J, M), np.int64)
        for m in range(M):
            for r in range(J):
                start_jm[o[m, r], m], tail_jm[o[m, r], m] = st[m, r], tl_[m, r]
        for m in range(M):
            for r in range(J):
                j = o[m, r]
                k = int(np.where(om[j] == m)[0][0])
                exp_jp = 0 if k == 0 else start_jm[j, om[j][k - 1]] + od[j][k - 1]
                exp_js = 0 if k == M - 1 else tail_jm[j, om[j][k + 1]] + od[j][k + 1]
                assert int(JP[0, m, r]) == exp_jp and int(JS[0, m, r]) == exp_js, (m, r)


def test_sweep_counts_passes_and_host_reads():
    """Each host read follows ``SWEEP_PASSES`` passes, and the pass count
    does not change the result (a pass is idempotent once a lane has
    completed or stalled)."""
    spec, orders, _ = _cases("rand6x5")
    t, _, _ = _tables(spec)
    ta.reset_sweep_stats()
    mk, starts = ta._sweep(t, orders)
    stats = dict(ta.SWEEP_STATS)
    assert stats["sweeps"] == 1 and stats["passes"] == ta.SWEEP_PASSES * stats["host_syncs"] > 0
    old = ta.SWEEP_PASSES
    try:
        for k in (1, 7):
            ta.SWEEP_PASSES = k
            mk_k, starts_k = ta._sweep(t, orders)
            assert torch.equal(mk_k, mk) and torch.equal(starts_k, starts)
    finally:
        ta.SWEEP_PASSES = old


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = te.state_from_spec(ti.get_instance("ta01"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.schedule_tables(s.op_machine[0], s.op_dur[0], s.op_pos[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.solve(ti.get_instance("ta01"), batch=4, sweeps=1)
