"""Plain free rollout: what one ``rollout_free`` call must return.

T steps of a uniform-over-legal policy on a freshly reset batch, finished
lanes restarted, with the episode statistics and the reward identity of the
reference env (``raw return == 2*sum_op - M*makespan``). The random word of
(step t, lane b) is word 0 of Philox4x32-10 keyed by the call's 64-bit seed
at counter (t, lane_offset + b, 0, 0); the action is the k-th legal job in
index order, ``k = (word >>> 1) mod (legal jobs + legal no-op)``, or the
no-op when k reaches past the legal jobs. Frozen here with the env
(``env.py``); it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import env

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def philox_word(seed: int, t: int, batch: int, device, lane_offset: int = 0) -> torch.Tensor:
    """(B,) int32: word 0 of Philox4x32-10(key=seed, counter=(t, lane, 0, 0)),
    its bits as they are. int64 products wrap as uint64 would, so the high
    32 bits of each 32x32 product are exact."""
    seed &= 2**64 - 1
    k0, k1 = seed & _U32, seed >> 32
    lane = (torch.arange(batch, dtype=torch.int64, device=device) + lane_offset) & _U32
    z = torch.zeros_like(lane)
    c0, c1, c2, c3 = z + (t & _U32), lane, z, z
    for _ in range(10):
        p0, p1 = c0 * _M0, c2 * _M1
        c0, c1, c2, c3 = ((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32, ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return (c0 - ((c0 >> 31) << 32)).to(torch.int32)


def uniform_legal(word: torch.Tensor, s: env.State) -> torch.Tensor:
    """The action drawn by ``word`` for each lane of ``s``."""
    k = ((word >> 1) & 0x7FFFFFFF) % torch.clamp(s["nb_legal"] + s["noop_legal"].to(torch.int32), min=1)
    chosen = s["legal"] & (torch.cumsum(s["legal"].to(torch.int32), dim=1) == (k + 1)[:, None])
    j = torch.arange(s["legal"].shape[1], dtype=torch.int32, device=word.device)
    job = torch.where(chosen, j, 0).sum(dim=1, dtype=torch.int32)
    return torch.where(k >= s["nb_legal"], s["num_jobs"], job)


def stats(s: env.State, steps: int, seed: int, lane_offset: int = 0,
          store_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """The summary of one free call from the fresh batch ``s``:
    ``episodes``, ``total_makespan``, ``min_makespan`` (2**31-1 when no
    episode ended), ``identity_violations`` and ``total_return`` (float32
    per lane, summed over lanes)."""
    B, dev = s["time"].shape[0], s["time"].device
    episodes = torch.zeros((B,), dtype=torch.int64, device=dev)
    mk_sum, viol = torch.zeros_like(episodes), torch.zeros_like(episodes)
    mk_min = torch.full((B,), env.I32_MAX, dtype=torch.int64, device=dev)
    ret = torch.zeros((B,), dtype=torch.float32, device=dev)
    ep_raw = torch.zeros((B,), dtype=torch.int32, device=dev)
    identity0 = 2 * s["sum_op"]
    scale = s["max_time_op"].to(torch.float32)
    for t in range(int(steps)):
        action = uniform_legal(philox_word(seed, t, B, dev, lane_offset), s)
        stepped, raw, done = env.step(s, action)
        stepped = env.narrow(stepped, store_dtype)
        ep_raw = ep_raw + raw
        mk = stepped["time"]
        episodes += done
        mk_sum += torch.where(done, mk, 0)
        mk_min = torch.where(done, torch.minimum(mk_min, mk.to(torch.int64)), mk_min)
        viol += done & (ep_raw != identity0 - stepped["num_machines"] * mk)
        ret = ret + raw.to(torch.float32) / scale
        ep_raw = torch.where(done, 0, ep_raw)
        s = env.reset_lanes(stepped, done)
    return {
        "episodes": int(episodes.sum()),
        "total_makespan": int(mk_sum.sum()),
        "min_makespan": int(mk_min.min()),
        "identity_violations": int(viol.sum()),
        "total_return": float(ret.sum()),
    }
