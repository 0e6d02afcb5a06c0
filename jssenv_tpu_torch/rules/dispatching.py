"""Dispatching rules as batched masked-priority functions.

The PyTorch counterpart of ``jssenv_tpu/rules/dispatching.py``. Each rule is
a function ``EnvState -> (B, J) priorities`` over a whole batch (no vmap);
action selection is one masked argmin/argmax per lane, so rule rollouts run
entirely on the state's device, while the class layer keeps the reference's
host API (``DispatchingRule``, ``DISPATCHING_RULES``, ``get_rule``,
``compare_rules``).

Selection semantics are the JAX package's, bit for bit at
``explore_prob=0``:
  * if the no-op is the only legal action, return it;
  * ties break to the lowest job index: ``torch.argmin``/``argmax`` return
    the first occurrence of the extremum on the CPU and on the card;
  * priorities are compared in float32 (CR divides in float32), as the JAX
    package does: float64 would break some ties differently;
  * the optional exploratory no-op coin is ``torch.rand`` on an explicit
    ``torch.Generator``. Its bits cannot match ``jax.random``'s, so with
    exploration the two packages agree in distribution only.

Due dates of CR are recomputed from the instance (``1.5 * total job work``),
never cached across envs, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from jssenv_tpu_torch.core import ops
from jssenv_tpu_torch.core.state import Device, EnvState

PriorityFn = Callable[[EnvState], torch.Tensor]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# priority functions (one per rule), (B, J) each
# ---------------------------------------------------------------------------


def current_op_duration(state: EnvState) -> torch.Tensor:
    """(B, J) duration of each job's current op — SPT key."""
    mp = state.machines_pad
    return ops.row_gather(state.op_dur, state.next_op.clamp(0, mp - 1))


def idle_since_last_op(state: EnvState) -> torch.Tensor:
    """(B, J) idle time since last op — FIFO key."""
    return state.idle_since_op


def remaining_work(state: EnvState) -> torch.Tensor:
    """(B, J) total processing time of ops not yet started — MWR/LWR/CR key
    (a masked suffix sum over op positions >= next_op)."""
    mp = state.machines_pad
    pos = torch.arange(mp, dtype=torch.int32, device=state.device)
    not_started = pos >= state.next_op[:, :, None]
    return torch.where(not_started, state.op_dur, 0).sum(dim=2, dtype=torch.int32)


def remaining_ops(state: EnvState) -> torch.Tensor:
    """(B, J) number of ops left — MOR/LOR key."""
    return state.num_machines[:, None] - state.next_op


def critical_ratio(state: EnvState, due_date_factor: float = 1.5) -> torch.Tensor:
    """(B, J) CR key: (due_date - now) / remaining work, in float32; +inf when
    done. Due date = factor * total job work."""
    total = state.op_dur.sum(dim=2, dtype=torch.int32).to(_F32)
    due = total * due_date_factor  # float32 arithmetic, as jnp.float32(factor)
    rem = remaining_work(state).to(_F32)
    time_left = due - state.time[:, None].to(_F32)
    return torch.where(rem > 0, time_left / rem, torch.inf)


# ---------------------------------------------------------------------------
# action selection
# ---------------------------------------------------------------------------


def select_action(
    state: EnvState,
    priority: torch.Tensor,
    minimize: bool,
    generator: Optional[torch.Generator] = None,
    explore_prob: float = 0.1,
) -> torch.Tensor:
    """(B,) int32 actions: masked argmin/argmax with the reference's selection
    protocol.

    Returns the no-op action id (``num_jobs``) where the no-op is the only
    legal action, or (when ``generator`` is given) with probability
    ``explore_prob`` wherever the no-op is legal. A terminal lane (no legal
    action at all) gets the no-op id, which ``step`` treats as an inert wait.
    The coin is drawn on the generator's device, one float per lane.
    """
    prio = priority.to(_F32)
    if minimize:
        best = torch.where(state.legal, prio, torch.inf).argmin(dim=1)
    else:
        best = torch.where(state.legal, prio, -torch.inf).argmax(dim=1)
    has_job = state.legal.any(dim=1)
    action = torch.where(has_job, best.to(torch.int32), state.num_jobs)
    if generator is not None:
        u = torch.rand((state.batch_size,), generator=generator, device=generator.device)
        coin = u.to(state.device) < explore_prob
        action = torch.where(state.noop_legal & coin, state.num_jobs, action)
    return action


# ---------------------------------------------------------------------------
# rule objects (reference-compatible API)
# ---------------------------------------------------------------------------


class DispatchingRule:
    """A named dispatching rule usable on host envs and batched state alike."""

    def __init__(
        self,
        name: str,
        description: str,
        priority_fn: PriorityFn,
        minimize: bool,
    ):
        self.name = name
        self.description = description
        self.priority_fn = priority_fn
        self.minimize = minimize

    def get_name(self) -> str:
        return self.name

    def get_description(self) -> str:
        return self.description

    # --- batched path ---
    def priorities(self, state: EnvState) -> torch.Tensor:
        return self.priority_fn(state)

    def action(
        self,
        state: EnvState,
        generator: Optional[torch.Generator] = None,
        explore_prob: float = 0.1,
    ) -> torch.Tensor:
        return select_action(
            state, self.priority_fn(state), self.minimize, generator, explore_prob
        )

    def policy(self, explore_prob: float = 0.0):
        """A batched policy ``(generator, state) -> actions`` for
        ``vector.rollout`` / ``vector.episode_makespans``; the coin is drawn
        only when ``explore_prob > 0``."""

        def _policy(generator, state):
            if explore_prob > 0.0:
                return self.action(state, generator, explore_prob)
            return self.action(state, None)

        return _policy

    # --- host path (gym-style env with .state, .step) ---
    def _host_priorities(self, env) -> np.ndarray:
        """Numpy twin of the priority function, reading the wrapper's public
        attributes (the way the reference rules read env internals). Float64,
        as in the JAX package's host path."""
        todo = np.asarray(env.todo_time_step_job)
        dur = np.asarray(env.instance_matrix[..., 1])
        machines = env.machines
        clip = np.clip(todo, 0, machines - 1)
        if self.name == "SPT":
            return dur[np.arange(env.jobs), clip].astype(np.float64)
        if self.name == "FIFO":
            return np.asarray(env.idle_time_jobs_last_op, dtype=np.float64)
        if self.name in ("MWR", "LWR", "CR"):
            cum = np.concatenate(
                [np.zeros((env.jobs, 1), np.int64), np.cumsum(dur, axis=1)], axis=1
            )
            remaining = dur.sum(axis=1) - cum[np.arange(env.jobs), np.minimum(todo, machines)]
            if self.name == "CR":
                due = dur.sum(axis=1) * 1.5
                time_left = due - env.current_time_step
                with np.errstate(divide="ignore"):
                    return np.where(
                        remaining > 0, time_left / np.maximum(remaining, 1), np.inf
                    )
            return remaining.astype(np.float64)
        if self.name in ("MOR", "LOR"):
            return (machines - todo).astype(np.float64)
        raise KeyError(self.name)  # pragma: no cover

    def __call__(self, env) -> int:
        """Select an action for a host env wrapper (see envs.gym_env.JssEnv).
        With the env's rule stream (``rule_seed``), one coin is drawn per
        decision on either engine, so both engines follow one stream."""
        generator = None
        if getattr(env, "rule_rng", None) is not None:
            generator = env.rule_rng.next_key()
        if getattr(env, "uses_native_engine", False):
            mask = env.get_legal_actions()
            legal = mask[:-1]
            prio = self._host_priorities(env)
            masked = np.where(legal, prio, np.inf if self.minimize else -np.inf)
            best = int(np.argmin(masked) if self.minimize else np.argmax(masked))
            action = best if legal.any() else env.jobs
            if generator is not None:
                u = float(torch.rand((1,), generator=generator, device=generator.device))
                if mask[-1] and u < 0.1:
                    action = env.jobs
            return action
        return int(self.action(env.engine_state, generator)[0])

    def run_episode(self, env) -> Tuple[float, int]:
        """Reset + follow this rule to termination; returns (return, makespan)."""
        env.reset()
        done = False
        total_reward = 0.0
        while not done:
            action = self(env)
            _, reward, done, _, _ = env.step(action)
            total_reward += float(reward)
        return total_reward, int(env.current_time_step)


DISPATCHING_RULES: Dict[str, DispatchingRule] = {
    "SPT": DispatchingRule(
        "SPT",
        "Shortest Processing Time: Schedule the job with the shortest processing time next",
        current_op_duration,
        minimize=True,
    ),
    "FIFO": DispatchingRule(
        "FIFO",
        "First In First Out: Schedule the job that has been waiting the longest",
        idle_since_last_op,
        minimize=False,
    ),
    "MWR": DispatchingRule(
        "MWR",
        "Most Work Remaining: Schedule the job with the most processing time remaining",
        remaining_work,
        minimize=False,
    ),
    "LWR": DispatchingRule(
        "LWR",
        "Least Work Remaining: Schedule the job with the least processing time remaining",
        remaining_work,
        minimize=True,
    ),
    "MOR": DispatchingRule(
        "MOR",
        "Most Operations Remaining: Schedule the job with the most operations remaining",
        remaining_ops,
        minimize=False,
    ),
    "LOR": DispatchingRule(
        "LOR",
        "Least Operations Remaining: Schedule the job with the fewest operations remaining",
        remaining_ops,
        minimize=True,
    ),
    "CR": DispatchingRule(
        "CR",
        "Critical Ratio: Schedule based on the ratio of time to due date versus remaining work",
        critical_ratio,
        minimize=True,
    ),
}


def get_rule(rule_name: str) -> DispatchingRule:
    """Look up a rule by name; raises ValueError on unknown names."""
    if rule_name not in DISPATCHING_RULES:
        raise ValueError(
            f"Rule '{rule_name}' not found. Available rules: "
            f"{list(DISPATCHING_RULES.keys())}"
        )
    return DISPATCHING_RULES[rule_name]


def compare_rules(
    env,
    rules: Optional[List[str]] = None,
    num_episodes: int = 10,
) -> Dict[str, Dict[str, float]]:
    """Run each rule for ``num_episodes`` episodes on a host env and average.

    The exploratory no-op coin only runs when the env carries a rule stream
    (``env_config={"rule_seed": <int>}``); by default every episode of a rule
    is identical."""
    if rules is None:
        rules = list(DISPATCHING_RULES.keys())
    results: Dict[str, Dict[str, float]] = {}
    for rule_name in rules:
        rule = get_rule(rule_name)
        total_reward = 0.0
        total_makespan = 0.0
        for _ in range(num_episodes):
            reward, makespan = rule.run_episode(env)
            total_reward += reward
            total_makespan += makespan
        results[rule_name] = {
            "avg_reward": total_reward / num_episodes,
            "avg_makespan": total_makespan / num_episodes,
        }
    return results


def compare_rules_batched(
    source,
    rules: Optional[List[str]] = None,
    num_episodes: int = 10,
    max_steps: int = 4096,
    explore_prob: float = 0.0,
    seed: int = 0,
    device: Device = None,
) -> Dict[str, Dict[str, float]]:
    """Batched compare_rules: every episode of every rule is a lane on
    ``device`` (the card unless "cpu" is given); one rollout per rule
    (``vector.episode_makespans``), rule ``i`` seeded with ``seed + i``.

    ``source`` is an InstanceSpec or InstanceSet (episodes tile across it).
    With ``explore_prob=0`` the rules are deterministic, so all episodes of a
    rule on one instance return identical makespans. Raises if an episode
    does not finish within ``max_steps``.
    """
    from jssenv_tpu_torch import vector  # local import to avoid cycles

    if rules is None:
        rules = list(DISPATCHING_RULES.keys())
    results: Dict[str, Dict[str, float]] = {}
    for i, rule_name in enumerate(rules):
        rule = get_rule(rule_name)
        state = vector.make_batch(source, num_episodes, device=device)
        generator = torch.Generator(device=state.device).manual_seed(seed + i)
        _, makespans, returns = vector.episode_makespans(
            generator,
            state,
            max_steps=max_steps,
            policy=rule.policy(explore_prob=explore_prob),
        )
        makespans = makespans.cpu().numpy()
        returns = returns.cpu().numpy()
        if (makespans == 0).any():
            raise RuntimeError(
                f"{rule_name}: {int((makespans == 0).sum())} episodes did not "
                f"finish within max_steps={max_steps}"
            )
        results[rule_name] = {
            "avg_reward": float(returns.mean()),
            "avg_makespan": float(makespans.mean()),
        }
    return results
