"""Checkpoints in the JAX package's npz format, and flax weights carried across.

The PyTorch counterpart of ``jssenv_tpu/checkpoint.py``. A checkpoint is one
compressed npz of named arrays: ``__names__``
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
* ``save_train_state`` / ``load_train_state`` hold a whole learner
  ``TrainState`` in that format, so that a killed run resumes where its last
  update left it.
* ``save_sharded`` / ``load_sharded``, the counterpart of the JAX package's
  orbax backend (``save_orbax`` / ``load_orbax``): a ``torch.distributed.
  checkpoint`` directory written by every rank of a mesh at once, each rank
  its own shards, and restorable at another mesh shape or in one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import tempfile
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from jssenv_tpu_torch.core.state import FIELD_NAMES, EnvState

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


_ADAM = ("step", "exp_avg", "exp_avg_sq")


def _train_state_arrays(ts) -> Dict[str, Any]:
    named = {f"model/{k}": v for k, v in ts.model.state_dict().items()}
    for k, p in ts.model.named_parameters():
        for leaf, v in ts.optimizer.state.get(p, {}).items():
            if leaf not in _ADAM:
                raise ValueError(f"optimizer state {leaf!r} of {k} is not Adam's")
            named[f"optim/{leaf}/{k}"] = v
    named.update({f"env/{k}": getattr(ts.env_state, k) for k in FIELD_NAMES})
    named["generator"] = ts.generator.get_state()
    named["steps"] = np.asarray(ts.steps, np.int64)
    return named


def save_train_state(path: str, ts) -> None:
    """Save a learner ``TrainState`` atomically (``save``): the net's
    ``state_dict`` (``model/<name>``), Adam's ``step``, ``exp_avg`` and
    ``exp_avg_sq`` of every parameter that has them (``optim/<leaf>/<name>``),
    every field of the env state (``env/<field>``), the generator's state
    and the update count."""
    save(path, _train_state_arrays(ts))


def load_train_state(path: str, template):
    """The ``TrainState`` saved at ``path``, restored into ``template`` (a
    ``TrainState`` of the same configuration and batch, e.g. a fresh
    ``learner.init_train_state``): the net's parameters and buffers copied
    in place, Adam's state set on the template's optimizer on each
    parameter's device and dtype, the env state on the template's device
    and dtypes, the generator's state restored (a CPU byte tensor for any
    device's generator). Raises ``ValueError`` where the saved names or
    shapes differ from the template's; Adam's entries may be absent (a
    state saved before its first update) or present for every parameter."""
    saved = load(path)
    want = _train_state_arrays(template)
    params = dict(template.model.named_parameters())
    optim = {f"optim/{leaf}/{k}" for k in params for leaf in _ADAM}
    base = [k for k in want if not k.startswith("optim/")]
    got_optim = {k for k in saved if k.startswith("optim/")}
    if [k for k in saved if not k.startswith("optim/")] != base or got_optim not in (set(), optim):
        raise ValueError(f"checkpoint structure mismatch: saved {len(saved)} arrays, template {len(want)}")
    for k in base:
        if k != "generator" and tuple(np.shape(saved[k])) != tuple(np.shape(_host(want[k]))):
            raise ValueError(f"checkpoint structure mismatch: {k} saved {np.shape(saved[k])}, "
                             f"template {tuple(np.shape(_host(want[k])))}")
    sd = template.model.state_dict()
    template.model.load_state_dict({k: torch.from_numpy(saved[f"model/{k}"]) for k in sd})
    opt = template.optimizer
    for k, p in params.items():
        if not got_optim:
            opt.state.pop(p, None)
            continue
        group = next(g for g in opt.param_groups if any(q is p for q in g["params"]))
        step_dev = p.device if group.get("capturable") or group.get("fused") else torch.device("cpu")
        opt.state[p] = {
            "step": torch.from_numpy(saved[f"optim/step/{k}"]).to(step_dev),
            "exp_avg": torch.from_numpy(saved[f"optim/exp_avg/{k}"]).to(p.device, p.dtype),
            "exp_avg_sq": torch.from_numpy(saved[f"optim/exp_avg_sq/{k}"]).to(p.device, p.dtype),
        }
    env = template.env_state
    env = env.replace(**{k: torch.from_numpy(saved[f"env/{k}"]).to(env.device, getattr(env, k).dtype)
                         for k in FIELD_NAMES})
    template.generator.set_state(torch.from_numpy(saved["generator"]))
    return dataclasses.replace(template, env_state=env, steps=int(saved["steps"]))


# ---------------------------------------------------------------------------
# sharded checkpoints over torch.distributed.checkpoint
# ---------------------------------------------------------------------------

# a shard's key: the whole tensor's name, then "@dp<rank>" (a block of env
# lanes, split along dim 0) or "@mp<rank>.<dim>" (a tensor-parallel shard)
_SHARD_KEY = re.compile(r"^(.*)@(dp|mp)(\d+)(?:\.(\d+))?$")


def _is_train_state(tree) -> bool:
    return all(hasattr(tree, a) for a in ("model", "optimizer", "env_state", "generator", "steps"))


def _sharded_arrays(tree, mesh) -> Dict[str, torch.Tensor]:
    """This rank's tensors of ``tree`` under shard keys. Plain tensors are
    taken as replicated by ``torch.distributed.checkpoint``, which keeps one
    rank's copy of a key, so each shard gets a key of its own: env lanes
    ``@dp<r>``, the tensor-parallel layers' parameters and Adam moments
    ``@mp<r>.<dim>``. Replicated entries (the other parameters, the
    generator, ``steps``) keep their plain names: every rank holds them
    alike."""
    dp = "" if mesh is None else f"@dp{mesh.dp_rank}"
    if isinstance(tree, EnvState):
        return {f"env/{k}{dp}": getattr(tree, k) for k in FIELD_NAMES}
    if not _is_train_state(tree):
        return dict(tree)
    from jssenv_tpu_torch.parallel import learner

    def mp(name, t):
        dim = None if mesh is None or not t.dim() else learner._split_dim(tree.model, name)
        return "" if dim is None else f"@mp{mesh.mp_rank}.{dim}"

    named = {f"model/{k}{mp(k, v)}": v for k, v in tree.model.state_dict().items()}
    for k, p in tree.model.named_parameters():
        for leaf, v in tree.optimizer.state.get(p, {}).items():
            if leaf not in _ADAM:
                raise ValueError(f"optimizer state {leaf!r} of {k} is not Adam's")
            named[f"optim/{leaf}/{k}{mp(k, v)}"] = v
    named.update({f"env/{k}{dp}": getattr(tree.env_state, k) for k in FIELD_NAMES})
    named["generator"] = tree.generator.get_state()
    named["steps"] = torch.tensor(tree.steps, dtype=torch.int64)
    return named


def save_sharded(path: str, tree, mesh=None) -> None:
    """Write ``tree`` (an ``EnvState``, a learner ``TrainState`` or a name ->
    tensor mapping) as a ``torch.distributed.checkpoint`` directory at
    ``path``. Under a process group every rank calls it with its own part
    and its place in ``mesh`` (``parallel.mesh.make_mesh``): its block of
    env lanes, its shards of a tensor-parallel net and their Adam moments;
    without a mesh the tree is one process's whole state."""
    named = {k: v.detach().cpu() for k, v in _sharded_arrays(tree, mesh).items()}
    import torch.distributed.checkpoint as dcp

    dcp.save(named, checkpoint_id=os.fspath(path), no_dist=not dist.is_initialized())


def _whole_arrays(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a sharded checkpoint, shards joined: env lanes in dp
    order along dim 0, tensor-parallel shards in mp order along their dim."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(os.fspath(path)).read_metadata().state_dict_metadata
    bufs = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(bufs, checkpoint_id=os.fspath(path), no_dist=not dist.is_initialized())
    whole, parts = {}, {}
    for k, t in bufs.items():
        m = _SHARD_KEY.match(k)
        if m is None:
            whole[k] = t
        else:
            parts.setdefault(m.group(1), []).append((int(m.group(3)), 0 if m.group(2) == "dp" else int(m.group(4)), t))
    for name, shards in parts.items():
        shards.sort(key=lambda x: x[0])
        if [r for r, _, _ in shards] != list(range(len(shards))):
            raise ValueError(f"checkpoint structure mismatch: {name} has shards {[r for r, _, _ in shards]}")
        whole[name] = torch.cat([t for _, _, t in shards], dim=shards[0][1])
    return whole


def _fit(name: str, t: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Saved tensor ``t`` on ``like``'s device and dtype, or ``ValueError``
    where it is missing or its shape differs."""
    if t is None:
        raise ValueError(f"checkpoint structure mismatch: {name} not saved")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint structure mismatch: {name} saved {tuple(t.shape)}, "
                         f"template {tuple(like.shape)}")
    return t.to(like.device, like.dtype)


def _env_from(whole: Dict[str, torch.Tensor], template: EnvState, mesh) -> EnvState:
    fields = {}
    for k in FIELD_NAMES:
        t = whole.get(f"env/{k}")
        if t is not None and mesh is not None:
            off, n = mesh.lanes(t.shape[0])
            t = t[off: off + n]
        fields[k] = _fit(f"env/{k}", t, getattr(template, k))
    return template.replace(**fields)


def load_sharded(path: str, template, mesh=None):
    """The tree saved by ``save_sharded`` at ``path``, restored into
    ``template`` (of the saved kind) on this rank's part of ``mesh``, which
    may have another shape than the saving mesh, or none (one process, the
    whole state). Shards are joined to whole tensors and split again: env
    lanes by ``mesh.lanes``, a tensor-parallel net's parameters and Adam
    moments by ``parallel.learner``'s partition. Under a process group
    every rank calls it. Raises ``ValueError`` where the saved names or
    whole shapes differ from the template's."""
    whole = _whole_arrays(path)
    if isinstance(template, EnvState):
        return _env_from(whole, template, mesh)
    if not _is_train_state(template):
        return {k: _fit(k, whole.get(k), v) for k, v in template.items()}
    from jssenv_tpu_torch.parallel import learner

    def mine(name, t, like):
        dim = None if mesh is None or not like.dim() else learner._split_dim(template.model, name)
        return t if dim is None else learner._shard(t, dim, mesh).clone()

    model = template.model
    sd = model.state_dict()
    params = dict(model.named_parameters())
    saved_optim = {k for k in whole if k.startswith("optim/")}
    want_optim = {f"optim/{leaf}/{k}" for k in params for leaf in _ADAM}
    base = {k for k in whole if not k.startswith("optim/")}
    want = {f"model/{k}" for k in sd} | {f"env/{k}" for k in FIELD_NAMES} | {"generator", "steps"}
    if base != want or saved_optim not in (set(), want_optim):
        raise ValueError(f"checkpoint structure mismatch: saved {sorted(base ^ want)[:4]} differ from the template")
    model.load_state_dict({k: _fit(k, mine(k, whole[f"model/{k}"], v), v) for k, v in sd.items()})
    opt = template.optimizer
    for k, p in params.items():
        if not saved_optim:
            opt.state.pop(p, None)
            continue
        group = next(g for g in opt.param_groups if any(q is p for q in g["params"]))
        step_dev = p.device if group.get("capturable") or group.get("fused") else torch.device("cpu")
        opt.state[p] = {"step": whole[f"optim/step/{k}"].to(step_dev)}
        for leaf in ("exp_avg", "exp_avg_sq"):
            opt.state[p][leaf] = _fit(f"optim/{leaf}/{k}", mine(k, whole[f"optim/{leaf}/{k}"], p), p)
    env = _env_from(whole, template.env_state, mesh)
    template.generator.set_state(whole["generator"])
    return dataclasses.replace(template, env_state=env, steps=int(whole["steps"]))
