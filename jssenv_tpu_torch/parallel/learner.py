"""Actor-learner: batched env rollouts feeding a policy-gradient learner.

The PyTorch counterpart of ``jssenv_tpu/parallel/learner.py`` (BASELINE.json
config #5). One ``train_step`` = a T-step on-policy rollout with auto-reset,
then the returns and a REINFORCE-with-baseline update, or GAE and PPO's
clipped surrogate over minibatch epochs.

On a mesh (``parallel.mesh``; ``make_train_step(config, mesh)``,
``train(..., mesh=...)``) each rank steps its block of the env lanes and,
with ``mp > 1``, holds a Megatron shard of the net (``partition_params``).
A sharded step computes the single-device step:

* every rank's generator is seeded alike and draws the noise of the global
  batch (``sample_action``'s ``lanes``) and PPO's permutation of the global
  trajectory, keeping its own rows: the same actions at every split;
* every mean over the global batch is this rank's sum over the global
  count, and the gradients and metrics are summed over ``dp``
  (``min_makespan`` minimised); PPO normalises its advantages with the
  global mean and population std, and a minibatch's loss on a rank is its
  share of the global minibatch's sum over the minibatch size;
* ``trunk_0``/``job_0`` are column-parallel and ``trunk_1``/``job_1``
  row-parallel over ``mp``; two autograd functions carry the
  communication (identity forward, gradient summed backward; sum forward,
  identity backward).

``mesh=None`` is the single-device step, its arithmetic unchanged.

Every env step of a rollout and of an evaluation is
``fused_rollout.step_autoreset`` (or ``rollout_driven`` at T=1): on a CUDA
state one launch of the driven kernel, on a CPU state its plain twin; there
is no other path. A step's net inputs with reference features are
``fused_rollout.observe`` (``policy_inputs``): one launch of the observation
kernel on a CUDA state, the plain ``EnvState`` expressions on a CPU one. The
policy nets and their gradients are plain PyTorch (``models.policy``,
autograd), as the JAX package left them to XLA.

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

import torch.distributed as dist
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from jssenv_tpu_torch import diagnostics, vector
from jssenv_tpu_torch.core import fused_rollout
from jssenv_tpu_torch.core.state import Device, EnvState, resolve_device
from jssenv_tpu_torch.models.policy import Dense, MaskedPolicyNet, PerJobPolicyNet, sample_action
from jssenv_tpu_torch.parallel import mesh as meshlib
from jssenv_tpu_torch.parallel import multihost


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


def policy_inputs(env_state: EnvState, config: LearnerConfig):
    """The net's inputs for ``env_state``: (obs, mask, valid). Reference
    features come from ``fused_rollout.observe`` (one launch on a CUDA
    state, the plain expressions on a CPU one); rich features from
    ``obs_batch``, ``action_mask()`` and ``valid_batch``."""
    if _features(config) == 7:
        return fused_rollout.observe(env_state)
    return obs_batch(env_state, config), env_state.action_mask(), valid_batch(env_state)


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
    model = init_model(seed, env_state, config, params)
    generator = torch.Generator(device=env_state.device).manual_seed(seed)
    return TrainState(model, make_optimizer(config, model.parameters()), env_state, generator)


def init_model(
    seed: int, env_state: EnvState, config: LearnerConfig, params: Optional[Mapping[str, torch.Tensor]] = None
) -> nn.Module:
    """The config's net on the env state's device: initialised from
    ``seed`` on a CPU generator (the same weights on any device), or
    loaded from ``params``, a ``state_dict``."""
    model = make_model(env_state, config)
    if params is None:
        g = torch.Generator().manual_seed(seed)
        for layer in model.modules():
            if isinstance(layer, Dense):
                layer.reset_parameters(g)
    else:
        model.load_state_dict(params)
    return model.to(env_state.device)


def _policy_rollout(model: nn.Module, env_state: EnvState, generator, config: LearnerConfig,
                    lanes: Optional[Tuple[int, int]] = None):
    """An on-policy T-step trajectory with auto-reset; each env step is
    ``fused_rollout.step_autoreset``. Returns (env_state, stats, traj): traj
    holds (T, B, ...) ``obs``, ``mask``, ``valid``, ``action`` (int64 mask
    index), ``reward``, ``done`` (float32), ``value``, ``logp``. ``lanes``:
    (offset, global batch) of a rank's block, for ``sample_action``. The
    span ``learner.rollout``; a step's ``policy.forward`` (its inputs in
    ``policy.observe``), ``policy.sample`` and ``env.step``."""
    with diagnostics.span("learner.rollout"):
        stats = vector.RolloutStats.zero(env_state.device)
        frames = []
        with torch.no_grad():
            for _ in range(config.unroll_steps):
                with diagnostics.span("policy.forward"):
                    with diagnostics.span("policy.observe"):
                        obs, mask, valid = policy_inputs(env_state, config)
                    logits, value = model(obs, mask, valid)
                with diagnostics.span("policy.sample"):
                    action_idx, logp = sample_action(generator, logits, lanes)
                    # padded no-op slot (index jobs_pad) -> env no-op action id (num_jobs)
                    actions = torch.where(action_idx == env_state.jobs_pad, env_state.num_jobs, action_idx)
                env_state, tr, stats = fused_rollout.step_autoreset(env_state, actions, stats)
                frames.append(dict(obs=obs, mask=mask, valid=valid, action=action_idx, reward=tr.reward,
                                   done=tr.done.to(torch.float32), value=value, logp=logp))
        traj = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
        return env_state, stats, traj


def _returns(traj: Dict[str, torch.Tensor], config: LearnerConfig) -> torch.Tensor:
    """Discounted returns-to-go with episode-boundary resets (the span
    ``learner.returns``)."""
    with diagnostics.span("learner.returns"):
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


def _mean(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    """The mean over the batch: ``x.mean()`` on one device; on a mesh
    (``count`` = the global number of elements) this rank's share, its sum
    over the global count, which the ``dp`` sum completes."""
    return x.mean() if count is None else x.sum() / count


def _entropy(logp_all: torch.Tensor, mask: torch.Tensor, count: Optional[int] = None) -> torch.Tensor:
    """Masked policy entropy with NaN-free gradients: the ``-inf`` log-probs
    are replaced before ``exp`` and the product."""
    safe_logp = torch.where(mask, logp_all, 0.0)
    probs = torch.where(mask, torch.exp(safe_logp), 0.0)
    return -_mean((probs * safe_logp).sum(dim=-1), count)


def _log_probs(model, obs, mask, valid, action):
    logits, values = model(obs, mask, valid)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[..., None])[..., 0]
    return logp_all, logp, values


def _metrics(loss, aux, stats: vector.RolloutStats, mesh: Optional[meshlib.Mesh]) -> Dict[str, torch.Tensor]:
    """The update's metrics; on a mesh, summed over ``dp`` (each rank's
    loss terms are its shares) and ``min_makespan`` minimised. The span
    ``learner.metrics``."""
    with diagnostics.span("learner.metrics"):
        m = dict(loss=loss, **aux, episodes=stats.episodes, total_makespan=stats.total_makespan,
                 min_makespan=stats.min_makespan)
        if mesh is None:
            return m
        floats, ints = ("loss", "pg_loss", "v_loss", "entropy"), ("episodes", "total_makespan")
        for keys in (floats, ints):
            m.update(zip(keys, meshlib.all_reduce(torch.stack([m[k] for k in keys]), mesh.dp_group)))
        m["min_makespan"] = meshlib.all_reduce(m["min_makespan"].clone(), mesh.dp_group, dist.ReduceOp.MIN)
        return m


def _lanes(env_state: EnvState, mesh: Optional[meshlib.Mesh]):
    """((offset, global batch), global batch) of this rank's lanes on a
    mesh (equal blocks, block ``dp_rank``); (None, None) without one."""
    if mesh is None:
        return None, None
    B = env_state.batch_size
    return (mesh.dp_rank * B, B * mesh.dp), B * mesh.dp


def _sum_grads(model: nn.Module, mesh: Optional[meshlib.Mesh]) -> None:
    """Sum the gradients over ``dp`` (one all-reduce of them all packed;
    the span ``learner.allreduce``, the host's enqueue)."""
    if mesh is None:
        return
    with diagnostics.span("learner.allreduce"):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = meshlib.all_reduce(_flatten_dense_tensors(grads), mesh.dp_group)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


def make_train_step(
    config: LearnerConfig, mesh: Optional[meshlib.Mesh] = None
) -> Callable[[TrainState], Tuple[TrainState, dict]]:
    """The train step of ``config.algo``; raises ``ValueError`` for an
    unknown algo, or for ``loss_chunks`` that does not divide
    ``unroll_steps``. Metrics: ``loss``, ``pg_loss``, ``v_loss``,
    ``entropy`` (detached scalars), ``episodes``, ``total_makespan``,
    ``min_makespan`` of the update's rollout, over the global batch.
    ``mesh``: the step of a rank's ``shard_train_state`` (module
    docstring); None for one device."""
    if config.algo == "ppo":
        return _make_ppo_step(config, mesh)
    if config.algo != "reinforce":
        raise ValueError(f"unknown algo {config.algo!r}")
    nc = max(int(config.loss_chunks), 1)
    if config.unroll_steps % nc != 0:
        raise ValueError(f"loss_chunks ({nc}) must divide unroll_steps ({config.unroll_steps})")
    tc = config.unroll_steps // nc

    def loss_fn(model, traj_c, rets_c, count):
        logp_all, logp, values = _log_probs(model, traj_c["obs"], traj_c["mask"], traj_c["valid"],
                                            traj_c["action"])
        adv = (rets_c - values).detach()
        pg_loss = -_mean(logp * adv, count)
        v_loss = _mean((values - rets_c) ** 2, count)
        ent = _entropy(logp_all, traj_c["mask"], count)
        loss = pg_loss + config.value_coef * v_loss - config.entropy_coef * ent
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        with diagnostics.span("learner.update"):
            lanes, global_b = _lanes(ts.env_state, mesh)
            count = None if mesh is None else tc * global_b
            env_state, stats, traj = _policy_rollout(ts.model, ts.env_state, ts.generator, config, lanes)
            rets = _returns(traj, config)
            with diagnostics.span("learner.loss"):
                ts.optimizer.zero_grad(set_to_none=True)
                # equal T-chunks: the full mean is the mean of the chunk means, so
                # the gradients accumulated over the chunks, divided once, are the
                # one-shot gradients
                loss, aux = 0.0, dict(pg_loss=0.0, v_loss=0.0, entropy=0.0)
                for c in range(nc):
                    sl = slice(c * tc, (c + 1) * tc)
                    traj_c = {k: traj[k][sl] for k in ("obs", "mask", "valid", "action")}
                    l, a = loss_fn(ts.model, traj_c, rets[sl], count)
                    l.backward()
                    loss = loss + l.detach()
                    aux = {k: aux[k] + a[k].detach() for k in aux}
                if nc > 1:
                    for p in ts.model.parameters():
                        if p.grad is not None:
                            p.grad /= nc
                    loss, aux = loss / nc, {k: v / nc for k, v in aux.items()}
            _sum_grads(ts.model, mesh)
            with diagnostics.span("learner.optimizer"):
                ts.optimizer.step()
            return dataclasses.replace(ts, env_state=env_state, steps=ts.steps + 1), _metrics(
                loss, aux, stats, mesh)

    return train_step


def _normalise(advs: torch.Tensor, mesh: Optional[meshlib.Mesh]) -> torch.Tensor:
    """(advs - mean) / (population std + 1e-8) over the global batch, as
    ``jnp.std`` (ddof 0); on a mesh, from the ``dp`` sums of the values and
    then of their squared deviations."""
    if mesh is None:
        return (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    n = advs.numel() * mesh.dp
    mean = meshlib.all_reduce(advs.sum(), mesh.dp_group) / n
    var = meshlib.all_reduce(((advs - mean) ** 2).sum(), mesh.dp_group) / n
    return (advs - mean) / (var.sqrt() + 1e-8)


def _local_rows(sel: torch.Tensor, lanes: Tuple[int, int], B: int) -> torch.Tensor:
    """The entries of ``sel`` (indices t * B_global + b into the global
    (T, B_global) trajectory) that fall in this rank's lanes, as indices
    into its (T, B) trajectory, in ``sel``'s order."""
    off, global_b = lanes
    t, b = sel // global_b, sel % global_b - off
    return (t * B + b)[(b >= 0) & (b < B)]


def _make_ppo_step(config: LearnerConfig, mesh: Optional[meshlib.Mesh] = None):
    """PPO: GAE advantages + clipped surrogate over minibatch epochs. On a
    mesh each minibatch is a slice of the permutation of the global
    trajectory; a rank's share of it may be of any size, its loss its sum
    over the global minibatch size."""

    def loss_fn(model, batch, count):
        logp_all, logp, values = _log_probs(model, batch["obs"], batch["mask"], batch["valid"],
                                            batch["action"])
        ratio = torch.exp(logp - batch["logp_old"])
        clipped = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
        pg_loss = -_mean(torch.minimum(ratio * batch["adv"], clipped * batch["adv"]), count)
        v_loss = _mean((values - batch["ret"]) ** 2, count)
        ent = _entropy(logp_all, batch["mask"], count)
        loss = pg_loss + config.value_coef * v_loss - config.entropy_coef * ent
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        lanes, global_b = _lanes(ts.env_state, mesh)
        env_state, stats, traj = _policy_rollout(ts.model, ts.env_state, ts.generator, config, lanes)
        with torch.no_grad():  # bootstrap value of the post-rollout state
            _, last_value = ts.model(*policy_inputs(env_state, config))
        advs = _gae(traj, last_value, config)
        rets = advs + traj["value"]
        advs = _normalise(advs, mesh)
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
        if mesh is not None:
            N = T * global_b  # the global trajectory's length
        mb_size = N // config.minibatches
        for _ in range(config.ppo_epochs):
            perm = torch.randperm(N, generator=ts.generator, device=env_state.device)
            for mb in range(config.minibatches):
                sel = perm[mb * mb_size:(mb + 1) * mb_size]
                if mesh is not None:
                    sel = _local_rows(sel, lanes, B)
                ts.optimizer.zero_grad(set_to_none=True)
                loss, aux = loss_fn(ts.model, {k: v[sel] for k, v in flat.items()},
                                    None if mesh is None else mb_size)
                loss.backward()
                _sum_grads(ts.model, mesh)
                ts.optimizer.step()
        aux = {k: v.detach() for k, v in aux.items()}
        return dataclasses.replace(ts, env_state=env_state, steps=ts.steps + 1), _metrics(
            loss.detach(), aux, stats, mesh)

    return train_step


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def greedy_policy(model: nn.Module, config: LearnerConfig) -> vector.Policy:
    """Deterministic policy: argmax over masked logits (no sampling)."""

    def policy(generator, env_state: EnvState) -> torch.Tensor:
        del generator
        with torch.no_grad():
            logits, _ = model(*policy_inputs(env_state, config))
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
                logits, _ = model(*policy_inputs(env_state, config))
            a_samp, _ = sample_action(generator, logits)
            a_samp[0] = torch.argmax(logits[0])
            actions = torch.where(a_samp == env_state.jobs_pad, env_state.num_jobs, a_samp)
        else:
            actions = greedy(generator, env_state)
        env_state, _, ends = fused_rollout.rollout_driven(env_state, actions[None], 1, return_ends=True)
        ms = torch.where(ms == 0, ends[0], ms)
        diagnostics.COUNTS["host_reads"] += 1
        if bool((ms > 0).all()):
            break
    diagnostics.COUNTS["host_reads"] += 1
    ms = ms.cpu()
    out: Dict[str, Any] = {"greedy_makespan": int(ms[0]), "steps": steps}
    if stochastic_lanes:
        out["best_sampled_makespan"] = int(ms.min())
        out["avg_sampled_makespan"] = float(ms[1:].double().mean())
    return out


# ---------------------------------------------------------------------------
# sharding layout
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward: a
    replicated input entering a column-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return meshlib.all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _SumOverGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward: the partial
    products of a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        return meshlib.all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelDense(Dense):
    """Output columns [r*h, (r+1)*h) of a ``Dense`` on mp rank r: its weight
    rows and bias shard, each output computed as the whole layer computes
    it."""

    def __init__(self, full: Dense, mesh: meshlib.Mesh):
        n = full.out_features // mesh.mp
        super().__init__(full.in_features, n, full.compute_dtype, device="meta")
        self.weight = nn.Parameter(_shard(full.weight.detach(), 0, mesh).clone())
        self.bias = nn.Parameter(_shard(full.bias.detach(), 0, mesh).clone())
        self.group = mesh.mp_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_CopyToGroup.apply(x, self.group))


class RowParallelDense(Dense):
    """Input rows [r*h, (r+1)*h) of a ``Dense``'s product on mp rank r: a
    float32 partial product of the compute-dtype operands, summed over mp,
    rounded to the compute dtype once and then the (whole) bias added, as
    flax ``Dense(dtype)`` rounds the whole product."""

    def __init__(self, full: Dense, mesh: meshlib.Mesh):
        n = full.in_features // mesh.mp
        super().__init__(n, full.out_features, full.compute_dtype, device="meta")
        self.weight = nn.Parameter(_shard(full.weight.detach(), 1, mesh).clone())
        self.bias = nn.Parameter(full.bias.detach().clone())
        self.group = mesh.mp_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        part = F.linear(x.to(dt).float(), self.weight.to(dt).float())
        return _SumOverGroup.apply(part, self.group).to(dt) + self.bias.to(dt)


# (column-parallel, row-parallel) layer pairs: the flat net's first two trunk
# layers, the perjob net's first two per-job layers; everything else is
# replicated
_TP_PAIRS = (("trunk_0", "trunk_1"), ("job_0", "job_1"))


def _shard(t: torch.Tensor, dim: int, mesh: meshlib.Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.mp
    return t.narrow(dim, mesh.mp_rank * n, n)


def _split_dim(model: nn.Module, name: str) -> Optional[int]:
    """The dim along which parameter ``name`` of a partitioned model is
    split over mp, or None where it is replicated."""
    layer_name, _, kind = name.rpartition(".")
    layer = getattr(model, layer_name, None)
    if isinstance(layer, ColumnParallelDense):
        return 0
    if isinstance(layer, RowParallelDense) and kind == "weight":
        return 1
    return None


def partition_params(model: nn.Module, mesh: meshlib.Mesh, mp_axis: str = "mp") -> nn.Module:
    """Megatron-style tensor parallelism over ``mp``, in place: ``trunk_0``
    (or ``job_0``) becomes column-parallel, its (h/mp, in) weight and bias
    this rank's shard; ``trunk_1`` (``job_1``) row-parallel, an (h', h/mp)
    weight and the whole bias; the heads stay replicated. Raises
    ``ValueError`` where the net has no such pair or mp does not divide h."""
    if mp_axis != "mp":
        raise ValueError(f"the mesh's tensor-parallel axis is 'mp', not {mp_axis!r}")
    pairs = [(c, r) for c, r in _TP_PAIRS if hasattr(model, c) and hasattr(model, r)]
    if not pairs:
        raise ValueError("tensor parallelism needs two hidden layers (trunk_0/trunk_1 or job_0/job_1)")
    for col, row in pairs:
        layer = getattr(model, col)
        if isinstance(layer, ColumnParallelDense):
            continue
        if layer.out_features % mesh.mp:
            raise ValueError(f"{col}: width {layer.out_features} not divisible by mp={mesh.mp}")
        setattr(model, col, ColumnParallelDense(layer, mesh))
        setattr(model, row, RowParallelDense(getattr(model, row), mesh))
    return model


def gather_params(model: nn.Module, mesh: Optional[meshlib.Mesh] = None) -> Dict[str, torch.Tensor]:
    """The whole net's ``state_dict`` from a partitioned one (every rank of
    the mp group calls it): each shard placed in a zero tensor of the whole
    shape and summed over mp, which adds only zeros to it. Without a mesh,
    or for a net that is not partitioned, a copy of the ``state_dict``."""
    out = {}
    for name, t in model.state_dict().items():
        dim = None if mesh is None else _split_dim(model, name)
        if dim is None:
            out[name] = t.detach().clone()
            continue
        shape = list(t.shape)
        shape[dim] *= mesh.mp
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        _shard(full, dim, mesh).copy_(t)
        out[name] = meshlib.all_reduce(full, mesh.mp_group)
    return out


def _place_params(ts: TrainState, mesh: meshlib.Mesh, mp_axis: Optional[str]) -> TrainState:
    """The net on the mesh's device, partitioned over mp when ``mp_axis``
    is given, and a new optimizer of the same kind over it whose Adam
    moments are the matching shards of the old ones."""
    named = dict(ts.model.named_parameters())
    old = {n: ts.optimizer.state[p] for n, p in named.items() if p in ts.optimizer.state}
    model = ts.model.to(mesh.device)
    if mp_axis is not None:
        partition_params(model, mesh, mp_axis)
    opt = type(ts.optimizer)(model.parameters(), **ts.optimizer.defaults)
    for name, p in model.named_parameters():
        if name not in old:
            continue
        dim = _split_dim(model, name)
        opt.state[p] = {
            k: (_shard(v, dim, mesh) if dim is not None and v.dim() else v).to(
                v.device if k == "step" else p.device).clone()
            for k, v in old[name].items()
        }
    return dataclasses.replace(ts, model=model, optimizer=opt)


def shard_train_state(
    ts: TrainState, mesh: meshlib.Mesh, dp_axis: str = "dp", mp_axis: Optional[str] = None
) -> TrainState:
    """This rank's part of a TrainState built on the whole batch, on the
    mesh's device: its block of env lanes (``mesh.shard_batch``), the net
    replicated, or over ``mp`` when ``mp_axis="mp"`` (``partition_params``),
    the optimizer's moments following their parameters. The generator
    stays as it is: every rank's is seeded alike. Raises ``ValueError``
    for another axis name, or a state whose generator is not on the
    mesh's kind of device."""
    if dp_axis != "dp":
        raise ValueError(f"the mesh's data-parallel axis is 'dp', not {dp_axis!r}")
    if ts.generator.device.type != mesh.device.type:
        raise ValueError(f"build the train state on {mesh.device.type}, the mesh's device, "
                         f"not on {ts.generator.device.type}")
    ts = dataclasses.replace(ts, env_state=meshlib.shard_batch(ts.env_state, mesh))
    return _place_params(ts, mesh, mp_axis)


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------


def train(
    source,
    batch_size: int = 1024,
    num_updates: int = 100,
    config: Optional[LearnerConfig] = None,
    mesh: Optional[meshlib.Mesh] = None,
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
    the loss, and the episodes and average makespan since the last one.

    ``mesh``: ``batch_size`` is the global batch; this rank builds only its
    own lanes (``multihost.host_sharded_batch``) on the mesh's device
    (``device`` must then be None), the net replicated, or partitioned
    over mp when the mesh has ``mp > 1``; the history is global."""
    config = config or LearnerConfig()
    if mesh is None:
        env_state = vector.make_batch(source, batch_size, device=resolve_device(device))
    elif device is not None:
        raise ValueError("with a mesh the env state lives on the mesh's device; pass no device")
    else:
        env_state = multihost.host_sharded_batch(source, batch_size, mesh)
    if light:
        env_state = vector.strip_solution(env_state)
    ts = init_train_state(seed, env_state, config, params=init_params)
    if mesh is not None and mesh.mp > 1:
        ts = _place_params(ts, mesh, "mp")
    step = make_train_step(config, mesh)
    history = []
    # episodes finish in lockstep bursts, so accumulate between log points
    acc_eps, acc_ms = 0, 0
    for i in range(num_updates):
        ts, m = step(ts)
        diagnostics.COUNTS["host_reads"] += 2
        acc_eps += int(m["episodes"])
        acc_ms += int(m["total_makespan"])
        if (i + 1) % log_every == 0 or i + 1 == num_updates:
            diagnostics.COUNTS["host_reads"] += 3
            avg_ms = acc_ms / acc_eps if acc_eps else float("nan")
            history.append(dict(update=i + 1, loss=float(m["loss"]), episodes=acc_eps, avg_makespan=avg_ms))
            log_fn(f"update {i + 1}: loss={float(m['loss']):.4f} episodes={acc_eps} "
                   f"avg_makespan={avg_ms:.0f} entropy={float(m['entropy']):.3f}")
            acc_eps, acc_ms = 0, 0
    return ts, history
