"""Faults planted in the program under test, to show that a run's check
fails on them (``tests/test_perfbench_faults.py``) and to read, at a cell's
own size, how far each moves the numbers compared (``run.py --fault``).
Never planted in a measured run.

* ``unchanged``: a step that returns its state unchanged (a free call that
  reports no progress; a learner update that leaves its train state as it
  found it: no optimizer step, the old env state);
* ``half_batch``: half of the batch left out and the rest scaled up (a free
  call's sums over the first half of the lanes, doubled; a loss whose means
  run over the first half of the lanes);
* ``exchange``: the gradient all-reduce between cards left out;
* ``altered``: an answer altered where it is produced (one more unit of
  makespan in a free call's stats; one more unit of raw reward on lane 0
  of every env step);
* ``padded_pool``: the per-job net's mean and max pools taken over every
  job row of a lane, its padded rows too (the net's ``valid`` dropped): a
  fault that only a batch with padded jobs can show.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "exchange", "altered", "padded_pool")


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` planted, for the block's length."""
    from jssenv_tpu_torch.core import engine, fused_rollout
    from jssenv_tpu_torch.models import policy
    from jssenv_tpu_torch.parallel import learner

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    free, make_step, step_env = fused_rollout.rollout_free, learner.make_train_step, fused_rollout.step_autoreset
    if name == "unchanged":
        patch(fused_rollout, "rollout_free",
              lambda state, T, **kw: {k: torch.zeros_like(v) for k, v in free(state, T, **kw).items()})

        def still(config, mesh=None):
            step = make_step(config, mesh)

            def run(ts):
                ts.optimizer.step = lambda *a, **k: None
                try:
                    return ts, step(ts)[1]
                finally:
                    del ts.optimizer.step
            return run
        patch(learner, "make_train_step", still)
    elif name == "half_batch":
        def half(state, T, **kw):
            keep = state.batch_size // 2
            out = free(state.replace(**{k: getattr(state, k)[:keep] for k in vars(state)}), T, **kw)
            return {k: v if k in ("min_makespan", "steps") else 2 * v for k, v in out.items()}
        patch(fused_rollout, "rollout_free", half)

        def half_mean(x, count):  # on a mesh a rank's share: its half's sum over the global half's count
            rest = x[:, : x.shape[1] // 2] if x.dim() > 1 else x
            return rest.mean() if count is None else rest.sum() / (count * rest.numel() / x.numel())
        patch(learner, "_mean", half_mean)
    elif name == "exchange":
        patch(learner, "_sum_grads", lambda model, mesh: None)
    elif name == "padded_pool":
        forward = policy.PerJobPolicyNet.forward
        patch(policy.PerJobPolicyNet, "forward", lambda self, obs, mask, valid=None: forward(self, obs, mask))
    else:
        def plus_one(state, T, **kw):
            out = free(state, T, **kw)
            return {**out, "total_makespan": out["total_makespan"] + 1}

        def bumped(state, actions, stats):
            state, tr, stats = step_env(state, actions, stats)
            raw = tr.raw_reward.clone()
            raw[0] += 1
            reward = raw.to(torch.float32) / state.max_time_op.to(torch.float32)
            return state, engine.Transition(reward=reward, raw_reward=raw, done=tr.done), stats
        patch(fused_rollout, "rollout_free", plus_one)
        patch(fused_rollout, "step_autoreset", bumped)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
