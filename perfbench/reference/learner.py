"""Plain learner: the policy nets, the REINFORCE loss and Adam, in float32.

What one update of the port's learner (``make_train_step`` with
``algo="reinforce"``) must compute, written from the algorithm and not from
the program: the configured net over the (J, C) observation of the
configured features (``env.features``), discounted returns-to-go reset at
episode ends, the loss
``-mean(logp * (ret - value)) + vc * mean((value - ret)^2) - ec * entropy``
and Adam as optax states it (b1, b2, eps outside the square root, bias
correction). Two nets (``learner.arch``): ``flat``, an MLP over the
flattened observation (ReLU trunk, a policy head of J+1 logits and a value
head); ``perjob``, one MLP shared by the job rows, pooled over the lane's
real jobs, that scores each job from its row and the pools and reads the
no-op and the value from the pools alone. Illegal actions get ``-inf``
logits. Float32 throughout, TF32 off. With ``fp8`` each dense layer's
product is a float8 GEMM as a float8 training recipe runs it
(``Float8Linear``): the benchmark's control, the precision below the one
the configuration states.

``follow`` replays the actions a program chose on the plain env
(``env.py``) and checks, on the way, each step's action mask, reward and
end against the program's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference import env

Params = Dict[str, torch.Tensor]


def scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` stored in ``dtype`` under one scale for the whole tensor (its
    largest magnitude onto the type's largest), and read back in float32."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, torch.finfo(dtype).max / amax, 1.0)
    return (x * scale).to(dtype).to(torch.float32) / scale


class Float8Linear(torch.autograd.Function):
    """``x @ w.T`` as a float8 GEMM of a training recipe: input and weight
    in e4m3, the output's gradient in e5m2, each under its own per-tensor
    scale; products accumulated and returned in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = scaled(x, torch.float8_e4m3fn), scaled(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        gq = scaled(grad, torch.float8_e5m2)
        return gq @ wq, gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])


def _dense(params: Params, x: torch.Tensor, name: str, fp8: bool) -> torch.Tensor:
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    return (Float8Linear.apply(x, w) if fp8 else F.linear(x, w)) + b


def _masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal actions at ``-inf``; a row with no legal action all 0."""
    logits = torch.where(mask, logits, -torch.inf)
    return torch.where(mask.any(dim=-1, keepdim=True), logits, 0.0)


def flat_forward(params: Params, obs: torch.Tensor, mask: torch.Tensor, depth: int, fp8: bool = False):
    """The flat net: (logits (..., J+1), value (...,))."""
    x = obs.reshape(obs.shape[:-2] + (-1,))
    for i in range(depth):
        x = F.relu(_dense(params, x, f"trunk_{i}", fp8))
    return _masked(_dense(params, x, "policy_head", fp8), mask), _dense(params, x, "value_head", fp8)[..., 0]


def perjob_forward(params: Params, obs: torch.Tensor, mask: torch.Tensor, valid: torch.Tensor, depth: int,
                   fp8: bool = False):
    """The per-job net: (logits (..., J+1), value (...,)). ``valid``
    (..., J): the lane's real job rows. The pools run over those rows
    alone: the mean is their sum over their count, the max their max (the
    program fills the other rows with -1e4 before its max, the same max of
    ReLU outputs). Padded rows are embedded and scored like any other;
    the mask leaves their logits at ``-inf``."""
    x = obs
    for i in range(depth):
        x = F.relu(_dense(params, x, f"job_{i}", fp8))
    real = valid[..., None]
    mean = torch.where(real, x, 0.0).sum(dim=-2) / valid.sum(dim=-1, keepdim=True).to(x.dtype)
    ctx = torch.cat([mean, torch.where(real, x, -torch.inf).amax(dim=-2)], dim=-1)
    rows = torch.cat([x, ctx[..., None, :].expand(x.shape[:-1] + ctx.shape[-1:])], dim=-1)
    jobs = _dense(params, F.relu(_dense(params, rows, "score_0", fp8)), "score_head", fp8)[..., 0]
    g = F.relu(_dense(params, ctx, "ctx_0", fp8))
    logits = torch.cat([jobs, _dense(params, g, "noop_head", fp8)], dim=-1)
    return _masked(logits, mask), _dense(params, g, "value_head", fp8)[..., 0]


def forward(params: Params, obs: torch.Tensor, mask: torch.Tensor, valid: torch.Tensor, learner: dict,
            fp8: bool = False):
    """The configured net (``learner["arch"]``): (logits (..., J+1) with
    -inf on illegal actions, value (...,)). With ``fp8`` every layer's
    product is ``Float8Linear``'s."""
    depth = len(learner["hidden"])
    if learner["arch"] == "flat":
        return flat_forward(params, obs, mask, depth, fp8)
    if learner["arch"] == "perjob":
        return perjob_forward(params, obs, mask, valid, depth, fp8)
    raise ValueError(f"unknown arch {learner['arch']!r}")


def returns(reward: torch.Tensor, done: torch.Tensor, gamma: float) -> torch.Tensor:
    out = torch.empty_like(reward)
    ret = torch.zeros_like(reward[0])
    for t in reversed(range(reward.shape[0])):
        ret = reward[t] + gamma * ret * (1.0 - done[t])
        out[t] = ret
    return out


def loss(params: Params, obs, mask, valid, action, rets, learner: dict, fp8: bool = False, share: float = 1.0):
    """(the loss, the net's logits, its values) over the samples given:
    each mean over them, times ``share``, their part of the update's
    samples (the loss over a T-chunk is its share of the update's)."""
    logits, values = forward(params, obs, mask, valid, learner, fp8)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[..., None])[..., 0]
    adv = (rets - values).detach()
    safe = torch.where(mask, logp_all, 0.0)
    entropy = -(torch.where(mask, torch.exp(safe), 0.0) * safe).sum(dim=-1).mean()
    value = (-(logp * adv).mean() + learner["value_coef"] * ((values - rets) ** 2).mean()
             - learner["entropy_coef"] * entropy)
    return value * share, logits.detach(), values.detach()


class Adam:
    """optax.adam: m, v moving averages, bias-corrected, eps outside the
    square root; ``state`` (``m``, ``v``, ``t``): where an optimizer that
    has already taken ``t`` steps stands."""

    def __init__(self, params: Params, lr: float, b1=0.9, b2=0.999, eps=1e-8, state: Optional[dict] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        state = state or {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                          "v": {k: torch.zeros_like(v) for k, v in params.items()}, "t": 0}
        self.m, self.v, self.t = dict(state["m"]), dict(state["v"]), state["t"]

    def step(self, params: Params, grads: Params) -> Params:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            out[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out


def follow(state: env.State, params: Params, steps: Sequence[Sequence[dict]], learner: dict,
           fp8: bool = False, adam: Optional[dict] = None) -> dict:
    """Replay the program's updates: ``steps[k][t]`` holds the program's
    (B,) ``actions``, its (B, J+1) ``mask`` before the step, its ``raw``
    rewards and ``done`` flags; ``adam``: the optimizer's state at the start
    (None: a fresh one). Returns ``losses`` (one per update), ``grads`` (the
    first update's gradient per leaf), ``params`` after the last update, the
    final env ``state``, ``logits`` (the first update's, (T, B, J+1)) and
    ``mismatches``: how many mask, reward and end entries differ from the
    program's. The loss and its gradient are summed over
    ``learner["loss_chunks"]`` equal T-chunks, each chunk's share of the
    update's means, so that only a chunk's activations are held at once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = Adam(params, learner["learning_rate"], *learner["adam"], state=adam)
    _, observe = env.features(learner["features"])
    mismatches, losses, first_grads, first_logits = 0, [], None, None
    J = state["legal"].shape[1]
    for update in steps:
        obs, masks, valid, acts, rewards, dones = [], [], [], [], [], []
        for rec in update:
            mask = env.action_mask(state)
            mismatches += int((mask != rec["mask"]).sum())
            obs.append(observe(state))
            masks.append(mask)
            valid.append(env.job_valid(state))
            acts.append(torch.where(rec["actions"] >= state["num_jobs"], J, rec["actions"]).long())
            state, raw, done = env.step_autoreset(state, rec["actions"])
            mismatches += int((raw != rec["raw"]).sum()) + int((done != rec["done"]).sum())
            rewards.append(raw.to(torch.float32) / state["max_time_op"].to(torch.float32))
            dones.append(done.to(torch.float32))
        rets = returns(torch.stack(rewards), torch.stack(dones), learner["gamma"])
        obs, masks, valid, acts = torch.stack(obs), torch.stack(masks), torch.stack(valid), torch.stack(acts)
        T, nc = len(update), learner["loss_chunks"]
        if T % nc:
            raise ValueError(f"loss_chunks ({nc}) must divide the {T} steps of an update")
        tc, total, grads, logits = T // nc, 0.0, None, []
        for c in range(nc):
            sl = slice(c * tc, (c + 1) * tc)
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            value, chunk_logits, _ = loss(leaves, obs[sl], masks[sl], valid[sl], acts[sl], rets[sl], learner, fp8,
                                          share=tc / T)
            part = torch.autograd.grad(value, list(leaves.values()))
            grads = dict(zip(leaves, part)) if grads is None else {k: grads[k] + g for k, g in zip(leaves, part)}
            total += float(value.detach())
            logits.append(chunk_logits)
            del value, part, leaves
        losses.append(total)
        if first_grads is None:
            first_logits = torch.cat(logits)
            first_grads = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            params = opt.step(params, grads)
        del obs, masks, valid, grads, logits
    return {"losses": losses, "grads": first_grads, "params": params, "state": state, "logits": first_logits,
            "mismatches": mismatches}
