"""Stateful vectorized env: an object-style surface over the batch layer, for
users who want a classic ``reset()/step(actions)`` loop over many envs without
managing the EnvState themselves.

The PyTorch counterpart of ``jssenv_tpu/envs/vec_env.py``. All stepping stays
on the state's device (the card unless ``device="cpu"``); host numpy
conversion happens only for the values the caller asked for
(``to_numpy=True``, the default).

Semantics: auto-reset — a lane that terminates is reset within the same
``step`` call (``vector.reset_lanes``, the reset of
``vector.step_autoreset``), and that step's ``done`` is True while the
returned observation is the fresh post-reset one. Final makespans are
surfaced in the info dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from jssenv_tpu_torch import vector
from jssenv_tpu_torch.core.state import Device, EnvState
from jssenv_tpu_torch.instances import InstanceSet, InstanceSpec, get_instance


class JssVectorEnv:
    """B lockstep job-shop envs with device-resident state.

    Args:
      source: instance name/path, InstanceSpec, or InstanceSet (instances tile
        round-robin across lanes).
      num_envs: number of lanes.
      autoreset: reset finished lanes inside step() (default True).
      to_numpy: return host numpy arrays (default) or leave outputs as
        tensors on the device (no host sync until you read them).
      device: where the lanes live; the card unless "cpu" is given.
    """

    def __init__(
        self,
        source: Union[str, InstanceSpec, InstanceSet],
        num_envs: int,
        autoreset: bool = True,
        to_numpy: bool = True,
        device: Device = None,
    ):
        if isinstance(source, str):
            source = get_instance(source)
        self._source = source
        self.num_envs = int(num_envs)
        self.autoreset = autoreset
        self.to_numpy = to_numpy
        self._state = vector.make_batch(source, self.num_envs, device=device)
        self.single_action_space_n = int(self._state.jobs_pad) + 1

    # --- functional core ---
    @staticmethod
    def _obs_of(state: EnvState):
        return {"real_obs": state.observation()["real_obs"], "action_mask": state.action_mask()}

    # --- public API ---
    @property
    def state(self) -> EnvState:
        """The underlying batched EnvState (device-resident)."""
        return self._state

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        del seed  # envs are deterministic; accepted for API convenience
        self._state = vector.vreset(self._state)
        return self._maybe_np(self._obs_of(self._state))

    def step(
        self, actions
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, dict]:
        """actions: (B,) int array; the no-op id for each lane is its
        ``num_jobs`` (equivalently: the last mask slot maps to jobs_pad).

        Returns (obs, reward (B,) float32, done (B,) bool,
        info={"makespan": (B,) int32 — final makespan on lanes that finished
        this step, 0 elsewhere; "raw_reward": (B,) int32}).
        """
        s = self._state
        actions = torch.as_tensor(actions, dtype=torch.int32, device=s.device)
        actions = torch.where(actions == s.jobs_pad, s.num_jobs, actions)
        new_state, tr = vector.vstep(s, actions)
        makespans = torch.where(tr.done, new_state.time, 0)
        self._state = vector.reset_lanes(new_state, tr.done) if self.autoreset else new_state
        obs = self._obs_of(self._state)
        info = {"makespan": makespans, "raw_reward": tr.raw_reward}
        if self.to_numpy:
            return (
                self._maybe_np(obs),
                tr.reward.cpu().numpy(),
                tr.done.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in info.items()},
            )
        return obs, tr.reward, tr.done, info

    def sample_legal_actions(self, seed_or_generator):
        """Uniform-random legal action per lane (device-side); ``seed_or_generator``
        is an int seed or a ``torch.Generator`` on the lanes' device."""
        gen = seed_or_generator
        if isinstance(gen, int):
            gen = torch.Generator(device=self._state.device).manual_seed(gen)
        a = vector.random_legal_actions(gen, self._state)
        return a.cpu().numpy() if self.to_numpy else a

    def _maybe_np(self, obs):
        if not self.to_numpy:
            return obs
        return {k: v.cpu().numpy() for k, v in obs.items()}
