"""Policy distillation from teacher schedules: imitation pretrain + RL finetune.

The PyTorch counterpart of ``jssenv_tpu/distill.py``. Replay a schedule (a
machine order: a published optimum, a solver's result) through the exact
engine, record every (observation, action mask, allocated job) decision,
pretrain the policy net on those pairs with cross-entropy, then hand its
``state_dict`` to ``learner.train(init_params=...)`` for on-policy
fine-tuning.

Not every schedule is a trajectory the agent could take: the replay
advances time where the agent's action space offers no legal no-op (as the
reference's golden tests call ``increase_time_step()`` directly), so the
pairs are state-conditioned action supervision, not a trajectory.

Differences from the JAX package, each by design:

* the replay steps ``core.engine`` on a one-lane state on the card (unless
  ``device="cpu"``) and brings one host copy of the legality rows to the
  host a decision (``replay._Rows``); the observations stay on the device
  until the end;
* the minibatch order comes from ``torch.randperm`` on a generator seeded
  with ``seed``, not ``jax.random``;
* label smoothing drops the illegal actions' ``-inf`` log-probabilities
  before the product (the JAX package multiplies them by 0 and gets NaN).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from jssenv_tpu_torch.core import engine
from jssenv_tpu_torch.core.state import Device, EnvState
from jssenv_tpu_torch.instances import InstanceSpec
from jssenv_tpu_torch.parallel import learner as learner_mod
from jssenv_tpu_torch.replay import _Rows

PAIR_KEYS = ("obs", "mask", "valid", "action")


def collect_teacher_pairs(
    spec: InstanceSpec,
    machine_order: Sequence[Sequence[int]],
    config: Optional[learner_mod.LearnerConfig] = None,
    device: Device = None,
) -> dict:
    """Replay ``machine_order`` through the engine on ``device`` (the card
    unless ``device="cpu"``), recording every allocation decision.

    Returns numpy arrays: ``obs (N, J, C)`` float32 (``rich_obs`` as it is
    for ``features="rich"``, else the reference observation), ``mask (N,
    J+1)`` bool, ``valid (N, J)`` bool, ``action (N,)`` int32 (the job id;
    no-ops never occur), and ``makespan`` (int). Raises ``RuntimeError`` if
    the order deadlocks."""
    config = config or learner_mod.LearnerConfig()
    state = engine.state_from_spec(spec, device=device)
    nm, nj = int(state.num_machines[0]), int(state.num_jobs[0])
    idx = [0] * nm
    order = [list(machine_order[m]) for m in range(nm)]
    obs_l, mask_l, act_l = [], [], []

    def obs_of(s: EnvState) -> torch.Tensor:
        return s.rich_obs[0] if config.features == "rich" else s.observation()["real_obs"][0]

    host = _Rows(state)
    while not host.done:
        acted = False
        for m in range(nm):
            if host.done:
                break
            if host.machine_legal[m] and idx[m] < len(order[m]):
                job = order[m][idx[m]]
                if host.needed[job] == m and host.legal[job]:
                    obs_l.append(obs_of(state))
                    mask_l.append(state.action_mask()[0])
                    act_l.append(job)
                    state, _ = engine.step(state, torch.full((1,), job, dtype=torch.int32, device=state.device))
                    idx[m] += 1
                    acted = True
                    host = _Rows(state)
        if not acted and not host.done:
            if not host.any_busy:
                raise RuntimeError("teacher schedule deadlocked in replay")
            state = engine.advance_time(state)[0]
            host = _Rows(state)
    J = state.jobs_pad
    return {
        "obs": torch.stack(obs_l).to(torch.float32).cpu().numpy(),
        "mask": torch.stack(mask_l).cpu().numpy(),
        "valid": np.broadcast_to(np.arange(J) < nj, (len(act_l), J)).copy(),
        "action": np.asarray(act_l, np.int32),
        "makespan": host.time,
    }


def merge_pairs(pair_sets: Sequence[dict]) -> dict:
    return {k: np.concatenate([p[k] for p in pair_sets]) for k in PAIR_KEYS}


def ce_loss(model: torch.nn.Module, batch: Dict[str, torch.Tensor], label_smooth: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of the teacher actions under ``model``. With
    ``label_smooth`` > 0 that fraction of the target mass is spread
    uniformly over each pair's legal actions (its mask); the illegal
    actions' ``-inf`` log-probabilities are dropped before the product, so
    the loss and its gradient stay finite."""
    logits, _ = model(batch["obs"], batch["mask"], batch["valid"])
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, batch["action"][:, None].long())[:, 0]
    if label_smooth > 0.0:
        legal = batch["mask"]
        n_legal = legal.sum(dim=1).clamp(min=1).to(logp.dtype)
        ce_unif = -torch.where(legal, logp, 0.0).sum(dim=1) / n_legal
        ce = (1.0 - label_smooth) * ce + label_smooth * ce_unif
    return ce.mean()


def pretrain(
    seed: int,
    pairs: dict,
    env_state: EnvState,
    config: learner_mod.LearnerConfig,
    epochs: int = 50,
    batch_size: int = 512,
    learning_rate: float = 1e-3,
    params: Optional[Dict[str, torch.Tensor]] = None,
    log_fn=None,
    label_smooth: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Cross-entropy imitation of the teacher actions (``ce_loss``) with
    ``learner.make_optimizer``'s Adam at ``learning_rate``; returns the
    net's ``state_dict``.

    ``env_state`` gives the net's shapes and the device (a 1-lane batch is
    fine); with ``config.arch="perjob"`` the result runs any (J, M). The net
    starts from ``params`` (a ``state_dict``) or is initialised from
    ``seed`` as ``learner.init_train_state`` does. Each epoch takes a
    ``torch.randperm`` of the N pairs from a generator seeded with ``seed``
    on the device and runs ``max(N // batch_size, 1)`` minibatches of it.
    ``log_fn`` receives "pretrain epoch e: ce=..." (the epoch's mean loss)
    at every tenth of the epochs."""
    dev = env_state.device
    model = learner_mod.init_model(seed, env_state, config, params)
    opt = learner_mod.make_optimizer(dataclasses.replace(config, learning_rate=learning_rate), model.parameters())
    data = {k: torch.as_tensor(np.asarray(pairs[k])).to(dev) for k in PAIR_KEYS}
    N = data["obs"].shape[0]
    nb = max(N // batch_size, 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for e in range(epochs):
        perm = torch.randperm(N, generator=gen, device=dev)
        total = torch.zeros((), device=dev)
        for i in range(nb):
            sel = perm[i * batch_size:(i + 1) * batch_size]
            opt.zero_grad(set_to_none=True)
            loss = ce_loss(model, {k: v[sel] for k, v in data.items()}, label_smooth)
            loss.backward()
            opt.step()
            total += loss.detach()
        if log_fn and (e + 1) % max(1, epochs // 10) == 0:
            log_fn(f"pretrain epoch {e + 1}: ce={float(total) / nb:.6f}")
    return model.state_dict()
