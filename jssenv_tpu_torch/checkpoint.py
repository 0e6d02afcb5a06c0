"""Checkpoints in the JAX package's npz format, and flax weights carried across.

The PyTorch counterpart of ``jssenv_tpu/checkpoint.py`` (its orbax backend is
not ported). A checkpoint is one compressed npz of named arrays: ``__names__``
holds the names in order, ``leaf_i`` the i-th array. The JAX package names
each leaf by its path in the pytree (``jax.tree_util.keystr``), e.g.
``['params']['trunk_0']['kernel']`` for a flax Dense kernel, and its ``load``
restores into a template whose flattened names must equal the saved ones.

* ``save`` / ``load`` write and read that format atomically (a temp file in
  the destination directory, then ``os.replace``).
* ``params_from_flax`` turns flax policy weights (a checkpoint path, a flat
  name -> array dict, or the nested ``{'params': {...}}`` tree) into a
  ``state_dict`` of the port's nets (``models.policy``): each Dense
  ``kernel`` (in, out) becomes the Linear ``weight`` (out, in).
* ``params_to_flax`` is the inverse: a module's weights as flax-named
  arrays in the JAX package's flattening order, so ``save(path,
  params_to_flax(model))`` loads into the JAX package's ``checkpoint.load``.
"""

from __future__ import annotations

import contextlib
import os
import re
import tempfile
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

_FLAX_NAME = re.compile(r"^\['params'\]\['([^']+)'\]\['(kernel|bias)'\]$")


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, named: Mapping[str, Any]) -> None:
    """Save named arrays (numpy arrays or tensors, in order) as one
    compressed npz, atomically: written to a unique temp file in the
    destination directory and renamed into place, so a crash mid-save leaves
    either the old complete file or the new one at ``path``. ``.npz`` is
    appended to a path without it, as ``numpy.savez`` would."""
    path = _npz_path(path)
    arrays = {f"leaf_{i}": _host(v) for i, v in enumerate(named.values())}
    arrays["__names__"] = np.asarray(list(named))
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def load(path: str) -> Dict[str, np.ndarray]:
    """The named arrays of a checkpoint written by ``save`` (or by the JAX
    package's ``checkpoint.save``), in saved order."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["__names__"]]
        return {n: z[f"leaf_{i}"] for i, n in enumerate(names)}


def _flat_flax(params: Union[str, os.PathLike, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """Flax weights in any accepted form -> flat keystr name -> array."""
    if isinstance(params, (str, os.PathLike)):
        return load(os.fspath(params))
    if "params" in params and isinstance(params["params"], Mapping):
        return {
            f"['params']['{layer}']['{leaf}']": np.asarray(v)
            for layer, leaves in params["params"].items()
            for leaf, v in leaves.items()
        }
    return {k: np.asarray(v) for k, v in params.items()}


def params_from_flax(params: Union[str, os.PathLike, Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
    """A flax Dense-layer checkpoint -> the port nets' ``state_dict``
    (float32 CPU tensors; ``load_state_dict`` moves them to the module's
    device). ``params``: an npz path, a flat name -> array dict as ``load``
    returns, or the nested flax ``{'params': {layer: {kernel, bias}}}``."""
    out = {}
    for name, arr in _flat_flax(params).items():
        m = _FLAX_NAME.match(name)
        if m is None:
            raise ValueError(f"not a flax Dense parameter: {name!r}")
        layer, leaf = m.groups()
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            if t.dim() != 2:
                raise ValueError(f"{name}: a Dense kernel is 2-d, got shape {tuple(t.shape)}")
            out[f"{layer}.weight"] = t.t().contiguous()
        else:
            out[f"{layer}.bias"] = t
    return out


def params_to_flax(module: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """A port net (or its ``state_dict``) -> flax-named float32 arrays in
    the JAX package's flattening order (layers, then ``bias`` before
    ``kernel``, sorted as ``jax.tree_util`` sorts dict keys); each Linear
    ``weight`` (out, in) becomes the Dense ``kernel`` (in, out)."""
    sd = module.state_dict() if isinstance(module, nn.Module) else module
    leaves = []
    for key, t in sd.items():
        layer, _, kind = key.rpartition(".")
        if kind not in ("weight", "bias") or not layer or "." in layer:
            raise ValueError(f"not a Dense parameter of a port net: {key!r}")
        arr = _host(t).astype(np.float32)
        leaves.append((layer, "kernel" if kind == "weight" else "bias", arr.T if kind == "weight" else arr))
    return {f"['params']['{layer}']['{leaf}']": np.ascontiguousarray(a) for layer, leaf, a in sorted(
        leaves, key=lambda x: (x[0], x[1]))}
