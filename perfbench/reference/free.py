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
    per lane, summed over lanes). On a card the steps run through
    ``replay``; ``s``'s tensors are never written."""
    B, dev = s["time"].shape[0], s["time"].device
    zeros = lambda: torch.zeros((B,), dtype=torch.int64, device=dev)  # noqa: E731
    acc = dict(t=torch.zeros((), dtype=torch.int64, device=dev), episodes=zeros(), mk_sum=zeros(), viol=zeros(),
               mk_min=torch.full((B,), env.I32_MAX, dtype=torch.int64, device=dev),
               ret=torch.zeros((B,), dtype=torch.float32, device=dev),
               ep_raw=torch.zeros((B,), dtype=torch.int32, device=dev))
    identity0 = 2 * s["sum_op"]
    scale = s["max_time_op"].to(torch.float32)

    def advance(s: env.State, acc: Dict[str, torch.Tensor]):
        action = uniform_legal(philox_word(seed, acc["t"], B, dev, lane_offset), s)
        stepped, raw, done = env.step(s, action)
        stepped = env.narrow(stepped, store_dtype)
        ep_raw = acc["ep_raw"] + raw
        mk = stepped["time"]
        return env.reset_lanes(stepped, done), dict(
            t=acc["t"] + 1,
            episodes=acc["episodes"] + done,
            mk_sum=acc["mk_sum"] + torch.where(done, mk, 0),
            viol=acc["viol"] + (done & (ep_raw != identity0 - stepped["num_machines"] * mk)),
            mk_min=torch.where(done, torch.minimum(acc["mk_min"], mk.to(torch.int64)), acc["mk_min"]),
            ret=acc["ret"] + raw.to(torch.float32) / scale,
            ep_raw=torch.where(done, 0, ep_raw),
        )

    if dev.type == "cuda":
        s, acc = replay(advance, s, acc, int(steps))
    else:
        for _ in range(int(steps)):
            s, acc = advance(s, acc)
    return {
        "episodes": int(acc["episodes"].sum()),
        "total_makespan": int(acc["mk_sum"].sum()),
        "min_makespan": int(acc["mk_min"].min()),
        "identity_violations": int(acc["viol"].sum()),
        "total_return": float(acc["ret"].sum()),
    }


def replay(advance, s: env.State, acc: Dict[str, torch.Tensor], steps: int):
    """``steps`` applications of ``advance`` to ``(s, acc)`` on a card: the
    first eagerly, the rest as one step captured in a CUDA graph that writes
    its result over the tensors of the first's and is replayed. The same
    kernels on the same values as the eager loop, without the host's
    launches at every step, which would make the check many times longer
    than the window. The tensors handed in are never written."""
    if steps == 0:
        return s, acc
    s, acc = advance(s, acc)
    if steps == 1:
        return s, acc
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        advance(s, acc)  # warm-up outside the capture; its result is dropped
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new_s, new_acc = advance(s, acc)
        for old, new in ((s, new_s), (acc, new_acc)):
            for k, v in new.items():
                if v is not old[k]:  # a field the step rewrites; the eager step made it, so it is this call's own
                    if v.dtype != old[k].dtype or v.shape != old[k].shape:
                        raise RuntimeError(f"replay: {k} changes from {old[k].dtype} {tuple(old[k].shape)} "
                                           f"to {v.dtype} {tuple(v.shape)} in a step")
                    old[k].copy_(v)
    for _ in range(steps - 1):
        graph.replay()
    return s, acc
