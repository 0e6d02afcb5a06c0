"""Config plumbing and env factory.

The PyTorch counterpart of ``jssenv_tpu/utils.py``: the two integration hooks
the reference exposes (``create_env`` for Ray/RLlib class lookup,
``assign_env_config`` for attribute-style override), on top of a
name->factory registry and a typed coercion helper, so new env flavors can
register themselves without editing this module.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping

import numpy as np

# ---------------------------------------------------------------------------
# Env factory registry
# ---------------------------------------------------------------------------

_ENV_REGISTRY: dict[str, Callable[[], type]] = {}


def register_env_class(name: str, loader: Callable[[], type]) -> None:
    """Register a lazily-imported env class under ``name``.

    ``loader`` is a zero-arg callable returning the class; lazy so importing
    :mod:`jssenv_tpu_torch.utils` never drags in torch or gymnasium.
    """
    _ENV_REGISTRY[name] = loader


def registered_env_names() -> tuple:
    return tuple(sorted(_ENV_REGISTRY))


def _load_gym_env() -> type:
    from jssenv_tpu_torch.envs.gym_env import JssEnv

    return JssEnv


def _load_vec_env() -> type:
    from jssenv_tpu_torch.envs.vec_env import JssVectorEnv

    return JssVectorEnv


register_env_class("jss-torch-v1", _load_gym_env)
register_env_class("jss-torch-vec-v1", _load_vec_env)


def create_env(config, *extra_pos, **extra_kw) -> type:
    """Resolve an env name (or a mapping carrying an ``env`` entry) to its
    class, for Ray/RLlib-style integration (returns the class, not an
    instance; the first parameter is named ``config`` so reference-style
    keyword callers keep working)."""
    wanted = config.get("env") if isinstance(config, Mapping) else config
    try:
        loader = _ENV_REGISTRY[wanted]
    except KeyError:
        raise NotImplementedError(f"Environment {wanted} not recognized.") from None
    return loader()


# ---------------------------------------------------------------------------
# Attribute-style config override
# ---------------------------------------------------------------------------


def _coerced(current, incoming):
    """Coerce ``incoming`` to the type of an existing attribute's value.

    Arrays pass through unchanged; everything else goes through the current
    value's constructor (so e.g. an int default turns "3" into 3).
    """
    if current is None or isinstance(current, np.ndarray):
        return incoming
    return type(current)(incoming)


def assign_env_config(target, overrides) -> None:
    """Apply ``overrides`` as attributes on ``target``, then re-apply any
    nested ``target.env_config`` mapping with type coercion against existing
    defaults."""
    for attr, raw in overrides.items():
        setattr(target, attr, raw)
    nested = getattr(target, "env_config", None)
    if not nested:
        return
    for attr, raw in nested.items():
        if hasattr(target, attr):
            raw = _coerced(getattr(target, attr), raw)
        setattr(target, attr, raw)


# ---------------------------------------------------------------------------
# Typed run settings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunSettings:
    """One typed bundle for the knobs scattered across env_config dicts.

    ``instance``: bundled instance name or Taillard file path.
    ``batch_size``: env lanes for vectorized rollouts.
    ``engine``: "torch" (default, on the card) | "native" | "auto" for the
    single-env gym wrapper.
    ``rule_seed``: seed for the rules' 10% exploratory no-op (None = greedy).
    ``mesh_shape``: optional (dp, mp) device mesh shape for scale-out.
    """

    instance: str = "ta80"
    batch_size: int = 4096
    engine: str = "torch"
    rule_seed: int | None = None
    mesh_shape: tuple | None = None

    def env_config(self) -> dict:
        """Render as the env_config dict the gym wrapper consumes."""
        out: dict = {"instance_path": self.instance, "engine": self.engine}
        if self.rule_seed is not None:
            out["rule_seed"] = self.rule_seed
        return out

    @classmethod
    def from_mapping(cls, mapping) -> "RunSettings":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in mapping.items() if k in known})
