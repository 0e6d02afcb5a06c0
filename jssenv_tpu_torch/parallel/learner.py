"""Actor-learner: batched env rollouts feeding a policy-gradient learner.

The PyTorch counterpart of ``jssenv_tpu/parallel/learner.py`` (BASELINE.json
config #5), on one device; its mesh placement (``partition_params``,
``shard_train_state``) belongs to the data-parallel slice. One
``train_step`` = a T-step on-policy rollout with auto-reset, then the
returns and a REINFORCE-with-baseline update, or GAE and PPO's clipped
surrogate over minibatch epochs.

Every env step of a rollout and of an evaluation is
``fused_rollout.step_autoreset`` (or ``rollout_driven`` at T=1): on a CUDA
state one launch of the driven kernel, on a CPU state its plain twin; there
is no other path. The policy nets and their gradients are plain PyTorch
(``models.policy``, autograd), as the JAX package left them to XLA.

Differences from the JAX package, each by design:

* random numbers come from the ``torch.Generator`` in ``TrainState``, on the
  env state's device, so sampled actions differ from ``jax.random``'s;
* ``LearnerConfig.compute_dtype`` sets the nets' compute dtype (bfloat16 by
  default, as the JAX nets fix it), so that an evaluation can run at
  float32;
* ``train_step`` updates the module and optimizer of its ``TrainState`` in
  place and returns the state with the new env state and step count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from jssenv_tpu_torch import vector
from jssenv_tpu_torch.core import fused_rollout
from jssenv_tpu_torch.core.state import Device, EnvState, resolve_device
from jssenv_tpu_torch.models.policy import Dense, MaskedPolicyNet, PerJobPolicyNet, sample_action


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    unroll_steps: int = 32
    gamma: float = 0.99
    learning_rate: float = 3e-4
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    hidden: Tuple[int, ...] = (256, 256)
    # algo: "reinforce" (returns-to-go baseline) or "ppo" (GAE + clipped
    # surrogate over several minibatch epochs)
    algo: str = "reinforce"
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ppo_epochs: int = 2
    minibatches: int = 4
    # observation features: "reference" = the 7 reference columns;
    # "rich" = those plus 6 rule-aligned channels (EnvState.rich_obs)
    features: str = "reference"
    # "flat" = MaskedPolicyNet (J*C -> J+1, size-locked); "perjob" =
    # PerJobPolicyNet (one checkpoint runs any (J, M))
    arch: str = "flat"
    # REINFORCE: split the (T, B) trajectory into this many equal T-chunks
    # and average their gradients (the loss is a mean, so the result is the
    # one-shot gradient up to float reassociation) at 1/chunks the backward
    # activation memory
    loss_chunks: int = 1
    # the nets' compute dtype; parameters are float32 either way
    compute_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    env_state: EnvState
    generator: torch.Generator  # on env_state's device
    steps: int = 0  # learner updates applied


def _features(config: LearnerConfig) -> int:
    if config.features not in ("reference", "rich"):
        raise ValueError(f"unknown features {config.features!r}")
    return 13 if config.features == "rich" else 7


def make_model(state: EnvState, config: LearnerConfig) -> nn.Module:
    """The config's net for ``state``'s padded sizes (on the CPU, float32
    parameters; callers move it)."""
    C = _features(config)
    if config.arch == "perjob":
        return PerJobPolicyNet(C, hidden=config.hidden[0], depth=len(config.hidden),
                               compute_dtype=config.compute_dtype)
    if config.arch != "flat":
        raise ValueError(f"unknown arch {config.arch!r}")
    return MaskedPolicyNet(state.jobs_pad + 1, state.jobs_pad * C, hidden=config.hidden,
                           compute_dtype=config.compute_dtype)


def valid_batch(env_state: EnvState) -> torch.Tensor:
    """(B, J) bool: which job rows exist per lane (ragged batches pad J)."""
    return env_state.job_valid


def obs_batch(env_state: EnvState, config: LearnerConfig) -> torch.Tensor:
    """(B, J, C) policy observation per ``config.features``, with column 0
    set to the legal mask (as the reference's observation)."""
    if _features(config) == 13:
        obs = env_state.rich_obs
        obs[..., 0] = env_state.legal.to(obs.dtype)
        return obs
    return env_state.observation()["real_obs"]


def make_optimizer(config: LearnerConfig, params) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root — ``torch.optim.Adam``'s update, stated here rather than
    left to its defaults."""
    return torch.optim.Adam(params, lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(
    seed: int, env_state: EnvState, config: LearnerConfig, params: Optional[Mapping[str, torch.Tensor]] = None
) -> TrainState:
    """``env_state``: a batch (B, ...). The net is initialised from ``seed``
    (the same weights on any device), or warm-started from ``params``, a
    ``state_dict`` (e.g. ``checkpoint.params_from_flax(path)``). The
    rollout generator is seeded with ``seed`` on the env state's device."""
    model = make_model(env_state, config)
    if params is None:
        g = torch.Generator().manual_seed(seed)
        for layer in model.modules():
            if isinstance(layer, Dense):
                layer.reset_parameters(g)
    else:
        model.load_state_dict(params)
    model = model.to(env_state.device)
    generator = torch.Generator(device=env_state.device).manual_seed(seed)
    return TrainState(model, make_optimizer(config, model.parameters()), env_state, generator)


def _policy_rollout(model: nn.Module, env_state: EnvState, generator, config: LearnerConfig):
    """An on-policy T-step trajectory with auto-reset; each env step is
    ``fused_rollout.step_autoreset``. Returns (env_state, stats, traj): traj
    holds (T, B, ...) ``obs``, ``mask``, ``valid``, ``action`` (int64 mask
    index), ``reward``, ``done`` (float32), ``value``, ``logp``."""
    stats = vector.RolloutStats.zero(env_state.device)
    frames = []
    with torch.no_grad():
        for _ in range(config.unroll_steps):
            obs = obs_batch(env_state, config)
            mask = env_state.action_mask()
            valid = valid_batch(env_state)
            logits, value = model(obs, mask, valid)
            action_idx, logp = sample_action(generator, logits)
            # padded no-op slot (index jobs_pad) -> env no-op action id (num_jobs)
            actions = torch.where(action_idx == env_state.jobs_pad, env_state.num_jobs, action_idx)
            env_state, tr, stats = fused_rollout.step_autoreset(env_state, actions, stats)
            frames.append(dict(obs=obs, mask=mask, valid=valid, action=action_idx, reward=tr.reward,
                               done=tr.done.to(torch.float32), value=value, logp=logp))
    traj = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    return env_state, stats, traj


def _returns(traj: Dict[str, torch.Tensor], config: LearnerConfig) -> torch.Tensor:
    """Discounted returns-to-go with episode-boundary resets."""
    rets = torch.empty_like(traj["reward"])
    ret = torch.zeros_like(traj["reward"][0])
    for t in reversed(range(traj["reward"].shape[0])):
        ret = traj["reward"][t] + config.gamma * ret * (1.0 - traj["done"][t])
        rets[t] = ret
    return rets


def _gae(traj: Dict[str, torch.Tensor], last_value: torch.Tensor, config: LearnerConfig) -> torch.Tensor:
    """Generalized advantage estimation with episode-boundary resets."""
    advs = torch.empty_like(traj["reward"])
    adv_next, v_next = torch.zeros_like(last_value), last_value
    for t in reversed(range(traj["reward"].shape[0])):
        nonterm = 1.0 - traj["done"][t]
        delta = traj["reward"][t] + config.gamma * v_next * nonterm - traj["value"][t]
        adv_next = delta + config.gamma * config.gae_lambda * nonterm * adv_next
        advs[t] = adv_next
        v_next = traj["value"][t]
    return advs


def _entropy(logp_all: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked policy entropy with NaN-free gradients: the ``-inf`` log-probs
    are replaced before ``exp`` and the product."""
    safe_logp = torch.where(mask, logp_all, 0.0)
    probs = torch.where(mask, torch.exp(safe_logp), 0.0)
    return -(probs * safe_logp).sum(dim=-1).mean()


def _log_probs(model, obs, mask, valid, action):
    logits, values = model(obs, mask, valid)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[..., None])[..., 0]
    return logp_all, logp, values


def _metrics(loss, aux, stats: vector.RolloutStats) -> Dict[str, torch.Tensor]:
    return dict(loss=loss, **aux, episodes=stats.episodes, total_makespan=stats.total_makespan,
                min_makespan=stats.min_makespan)


def make_train_step(config: LearnerConfig) -> Callable[[TrainState], Tuple[TrainState, dict]]:
    """The train step of ``config.algo``; raises ``ValueError`` for an
    unknown algo, or for ``loss_chunks`` that does not divide
    ``unroll_steps``. Metrics: ``loss``, ``pg_loss``, ``v_loss``,
    ``entropy`` (detached scalars), ``episodes``, ``total_makespan``,
    ``min_makespan`` of the update's rollout."""
    if config.algo == "ppo":
        return _make_ppo_step(config)
    if config.algo != "reinforce":
        raise ValueError(f"unknown algo {config.algo!r}")
    nc = max(int(config.loss_chunks), 1)
    if config.unroll_steps % nc != 0:
        raise ValueError(f"loss_chunks ({nc}) must divide unroll_steps ({config.unroll_steps})")
    tc = config.unroll_steps // nc

    def loss_fn(model, traj_c, rets_c):
        logp_all, logp, values = _log_probs(model, traj_c["obs"], traj_c["mask"], traj_c["valid"],
                                            traj_c["action"])
        adv = (rets_c - values).detach()
        pg_loss = -(logp * adv).mean()
        v_loss = ((values - rets_c) ** 2).mean()
        ent = _entropy(logp_all, traj_c["mask"])
        loss = pg_loss + config.value_coef * v_loss - config.entropy_coef * ent
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        env_state, stats, traj = _policy_rollout(ts.model, ts.env_state, ts.generator, config)
        rets = _returns(traj, config)
        ts.optimizer.zero_grad(set_to_none=True)
        # equal T-chunks: the full mean is the mean of the chunk means, so the
        # gradients accumulated over the chunks, divided once, are the
        # one-shot gradients
        loss, aux = 0.0, dict(pg_loss=0.0, v_loss=0.0, entropy=0.0)
        for c in range(nc):
            sl = slice(c * tc, (c + 1) * tc)
            traj_c = {k: traj[k][sl] for k in ("obs", "mask", "valid", "action")}
            l, a = loss_fn(ts.model, traj_c, rets[sl])
            l.backward()
            loss = loss + l.detach()
            aux = {k: aux[k] + a[k].detach() for k in aux}
        if nc > 1:
            for p in ts.model.parameters():
                if p.grad is not None:
                    p.grad /= nc
            loss, aux = loss / nc, {k: v / nc for k, v in aux.items()}
        ts.optimizer.step()
        return dataclasses.replace(ts, env_state=env_state, steps=ts.steps + 1), _metrics(loss, aux, stats)

    return train_step


def _make_ppo_step(config: LearnerConfig):
    """PPO: GAE advantages + clipped surrogate over minibatch epochs."""

    def loss_fn(model, batch):
        logp_all, logp, values = _log_probs(model, batch["obs"], batch["mask"], batch["valid"],
                                            batch["action"])
        ratio = torch.exp(logp - batch["logp_old"])
        clipped = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
        pg_loss = -torch.minimum(ratio * batch["adv"], clipped * batch["adv"]).mean()
        v_loss = ((values - batch["ret"]) ** 2).mean()
        ent = _entropy(logp_all, batch["mask"])
        loss = pg_loss + config.value_coef * v_loss - config.entropy_coef * ent
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        env_state, stats, traj = _policy_rollout(ts.model, ts.env_state, ts.generator, config)
        with torch.no_grad():  # bootstrap value of the post-rollout state
            _, last_value = ts.model(obs_batch(env_state, config), env_state.action_mask(),
                                     valid_batch(env_state))
        advs = _gae(traj, last_value, config)
        rets = advs + traj["value"]
        # population std (ddof 0), as jnp.std
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        T, B = traj["reward"].shape
        N = T * B
        flat = {
            "obs": traj["obs"].reshape(N, *traj["obs"].shape[2:]),
            "mask": traj["mask"].reshape(N, -1),
            "valid": traj["valid"].reshape(N, -1),
            "action": traj["action"].reshape(N),
            "logp_old": traj["logp"].reshape(N),
            "adv": advs.reshape(N),
            "ret": rets.reshape(N),
        }
        mb_size = N // config.minibatches
        for _ in range(config.ppo_epochs):
            perm = torch.randperm(N, generator=ts.generator, device=env_state.device)
            for mb in range(config.minibatches):
                sel = perm[mb * mb_size:(mb + 1) * mb_size]
                ts.optimizer.zero_grad(set_to_none=True)
                loss, aux = loss_fn(ts.model, {k: v[sel] for k, v in flat.items()})
                loss.backward()
                ts.optimizer.step()
        aux = {k: v.detach() for k, v in aux.items()}
        return dataclasses.replace(ts, env_state=env_state, steps=ts.steps + 1), _metrics(
            loss.detach(), aux, stats)

    return train_step


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def greedy_policy(model: nn.Module, config: LearnerConfig) -> vector.Policy:
    """Deterministic policy: argmax over masked logits (no sampling)."""

    def policy(generator, env_state: EnvState) -> torch.Tensor:
        del generator
        with torch.no_grad():
            logits, _ = model(obs_batch(env_state, config), env_state.action_mask(), valid_batch(env_state))
        a = torch.argmax(logits, dim=-1)
        return torch.where(a == env_state.jobs_pad, env_state.num_jobs, a)

    return policy


def evaluate_policy(
    params: Mapping[str, torch.Tensor],
    source,
    config: LearnerConfig,
    stochastic_lanes: int = 0,
    seed: int = 0,
    max_steps: Optional[int] = None,
    device: Device = None,
) -> Dict[str, Any]:
    """Greedy-argmax rollout to the first episode end, on ``device`` (the
    card unless ``device="cpu"``). ``params``: a ``state_dict`` of the
    config's net. With ``stochastic_lanes`` > 0, that many sampled-policy
    lanes run beside the greedy one and their best and mean makespans are
    reported too.

    Each step is one ``fused_rollout.rollout_driven`` step with ends (the
    driven kernel on the card); a lane's makespan is its first end, the
    makespan of the JAX package's freeze-on-done ``episode_makespans``. The
    loop stops once every lane has ended or at ``max_steps`` (by default
    ``4*J*M + 64``). Returns ``greedy_makespan`` (0 if the greedy lane did
    not finish), ``steps`` and, with sampled lanes, ``best_sampled_makespan``
    and ``avg_sampled_makespan``."""
    dev = resolve_device(device)
    B = 1 + int(stochastic_lanes)
    env_state = vector.strip_solution(vector.make_batch(source, B, device=dev))
    model = make_model(env_state, config)
    model.load_state_dict(params)
    model = model.to(dev).eval()
    greedy = greedy_policy(model, config)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if max_steps is None:
        max_steps = 4 * env_state.jobs_pad * env_state.machines_pad + 64
    ms = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps = 0
    for steps in range(1, int(max_steps) + 1):
        if stochastic_lanes:
            with torch.no_grad():
                logits, _ = model(obs_batch(env_state, config), env_state.action_mask(),
                                  valid_batch(env_state))
            a_samp, _ = sample_action(generator, logits)
            a_samp[0] = torch.argmax(logits[0])
            actions = torch.where(a_samp == env_state.jobs_pad, env_state.num_jobs, a_samp)
        else:
            actions = greedy(generator, env_state)
        env_state, _, ends = fused_rollout.rollout_driven(env_state, actions[None], 1, return_ends=True)
        ms = torch.where(ms == 0, ends[0], ms)
        if bool((ms > 0).all()):
            break
    ms = ms.cpu()
    out: Dict[str, Any] = {"greedy_makespan": int(ms[0]), "steps": steps}
    if stochastic_lanes:
        out["best_sampled_makespan"] = int(ms.min())
        out["avg_sampled_makespan"] = float(ms[1:].double().mean())
    return out


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------


def train(
    source,
    batch_size: int = 1024,
    num_updates: int = 100,
    config: Optional[LearnerConfig] = None,
    seed: int = 0,
    log_every: int = 10,
    log_fn=print,
    light: bool = True,
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
    device: Device = None,
):
    """Host loop: build ``batch_size`` envs on ``device`` (the card unless
    ``device="cpu"``), then run ``num_updates`` train steps. ``light=True``
    drops the solution matrix from the env state (training never reads it;
    ``vector.strip_solution``). ``init_params`` warm-starts the policy (a
    ``state_dict``). Returns (TrainState, history): per log point the update,
    the loss, and the episodes and average makespan since the last one."""
    config = config or LearnerConfig()
    env_state = vector.make_batch(source, batch_size, device=resolve_device(device))
    if light:
        env_state = vector.strip_solution(env_state)
    ts = init_train_state(seed, env_state, config, params=init_params)
    step = make_train_step(config)
    history = []
    # episodes finish in lockstep bursts, so accumulate between log points
    acc_eps, acc_ms = 0, 0
    for i in range(num_updates):
        ts, m = step(ts)
        acc_eps += int(m["episodes"])
        acc_ms += int(m["total_makespan"])
        if (i + 1) % log_every == 0 or i + 1 == num_updates:
            avg_ms = acc_ms / acc_eps if acc_eps else float("nan")
            history.append(dict(update=i + 1, loss=float(m["loss"]), episodes=acc_eps, avg_makespan=avg_ms))
            log_fn(f"update {i + 1}: loss={float(m['loss']):.4f} episodes={acc_eps} "
                   f"avg_makespan={avg_ms:.0f} entropy={float(m['entropy']):.3f}")
            acc_eps, acc_ms = 0, 0
    return ts, history
