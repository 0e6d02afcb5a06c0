"""Instance layer: Taillard-format parsing, bundled-instance registry, padding/stacking.

The PyTorch port's own copy of ``jssenv_tpu/instances.py`` (numpy only, same
behaviour, same bundled ``data/instances.npz``): the port imports nothing from
the JAX package.

The reference parses a Taillard text file inline inside the env constructor
(reference: JSSEnv/envs/jss_env.py:72-95) and ships 85 instance files as package
data. Here the instance layer is a standalone module that produces device-ready
int32 tensors:

* ``InstanceSpec`` — one parsed instance as a pair of ``(jobs, machines)`` int32
  arrays (machine id / duration per operation) plus the derived scalars the
  simulator and observation normalizers need (``max_time_op``, ``max_time_jobs``,
  ``sum_op``, ``jobs_length``; reference semantics at jss_env.py:86-95).
* ``InstanceSet`` — N instances padded to a common ``(J_pad, M_pad)`` so a mixed
  suite batches under one jit shape (SURVEY.md §7 "ragged instances").
* a registry of the 85 bundled benchmark instances (ta01-ta80, dmu16-dmu20),
  stored as a single packed ``.npz`` of stacked tensors instead of 85 text files
  — one mmap-able load, already in the layout the engine wants.

Text parsing remains available for arbitrary user-supplied files, matching the
format mandated by the reference README (line 1 = ``jobs machines``; each
following line = ``machines`` pairs of ``machine_id duration``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
_BUNDLED_NPZ = os.path.join(_DATA_DIR, "instances.npz")


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """A single parsed job-shop instance (host-side, numpy).

    ``op_machine[j, k]`` / ``op_dur[j, k]`` give the machine id and integer
    duration of the k-th operation of job j. Arrays may be padded beyond
    ``(num_jobs, num_machines)`` with zeros; the real dims are authoritative.
    """

    name: str
    num_jobs: int
    num_machines: int
    op_machine: np.ndarray  # (J, M) int32
    op_dur: np.ndarray  # (J, M) int32

    def __post_init__(self):
        if self.num_jobs <= 0:
            raise ValueError("instance must have at least one job")
        if self.num_machines <= 1:
            raise ValueError("instance must have at least 2 machines")
        if int(self.op_dur[: self.num_jobs, : self.num_machines].max()) <= 0:
            raise ValueError("instance must contain a positive duration")
        # JSSP contract: each job visits each machine exactly once (holds for
        # every Taillard/DMU instance and the reference's format; the engine's
        # static inverse-permutation tables rely on it)
        om = self.op_machine[: self.num_jobs, : self.num_machines]
        if not (np.sort(om, axis=1) == np.arange(self.num_machines)).all():
            raise ValueError(
                "each job must visit each machine exactly once "
                "(op_machine rows must be permutations of 0..machines-1)"
            )

    # Derived scalars (reference: jss_env.py:86-89).
    @property
    def jobs_length(self) -> np.ndarray:
        """Total work per job, shape (J,) int32 (zero on padded jobs)."""
        return self.op_dur.sum(axis=1, dtype=np.int32)

    @property
    def max_time_op(self) -> int:
        return int(self.op_dur.max())

    @property
    def max_time_jobs(self) -> int:
        return int(self.jobs_length.max())

    @property
    def sum_op(self) -> int:
        return int(self.op_dur.sum())

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_jobs, self.num_machines)

    def lower_bound(self) -> int:
        """A certified makespan lower bound from the instance tensors alone.

        ``max(max machine load, max job duration-chain)``: every machine must
        process all work routed to it, and every job's operations are a chain —
        both are classic JSSP lower bounds and need one reduction each over the
        bundled tensors. Used to anchor solver gaps on instances with no
        published optimum bundled (e.g. dmu16-dmu20).
        """
        om = self.op_machine[: self.num_jobs, : self.num_machines]
        od = self.op_dur[: self.num_jobs, : self.num_machines].astype(np.int64)
        machine_load = np.bincount(
            om.ravel(), weights=od.ravel(), minlength=self.num_machines
        )
        return int(max(machine_load.max(), od.sum(axis=1).max()))

    def padded(self, jobs_pad: int, machines_pad: int) -> "InstanceSpec":
        """Return a copy padded with zeros to at least (jobs_pad, machines_pad)."""
        jp = max(jobs_pad, self.op_machine.shape[0])
        mp = max(machines_pad, self.op_machine.shape[1])
        om = np.zeros((jp, mp), dtype=np.int32)
        od = np.zeros((jp, mp), dtype=np.int32)
        om[: self.op_machine.shape[0], : self.op_machine.shape[1]] = self.op_machine
        od[: self.op_dur.shape[0], : self.op_dur.shape[1]] = self.op_dur
        return dataclasses.replace(self, op_machine=om, op_dur=od)

    def to_text(self) -> str:
        """Serialize back to the Taillard text format."""
        lines = [f"{self.num_jobs} {self.num_machines}"]
        for j in range(self.num_jobs):
            pairs = []
            for k in range(self.num_machines):
                pairs.append(f"{int(self.op_machine[j, k])} {int(self.op_dur[j, k])}")
            lines.append(" ".join(pairs))
        return "\n".join(lines) + "\n"


def parse_taillard_text(text: str, name: str = "instance") -> InstanceSpec:
    """Parse an instance in Taillard text format.

    Format (reference README + jss_env.py:72-88): first non-empty line is
    ``jobs machines``; each of the following ``jobs`` lines holds ``machines``
    pairs ``machine_id duration`` in operation order, machine ids 0-indexed.
    """
    rows = [line.split() for line in text.splitlines() if line.strip()]
    if not rows:
        raise ValueError(f"{name}: empty instance file")
    header = list(map(int, rows[0]))
    if len(header) < 2:
        raise ValueError(f"{name}: header must be 'jobs machines'")
    jobs, machines = header[0], header[1]
    if len(rows) - 1 < jobs:
        raise ValueError(f"{name}: expected {jobs} job lines, got {len(rows) - 1}")
    op_machine = np.zeros((jobs, machines), dtype=np.int32)
    op_dur = np.zeros((jobs, machines), dtype=np.int32)
    for j in range(jobs):
        vals = list(map(int, rows[1 + j]))
        if len(vals) % 2 != 0 or len(vals) // 2 != machines:
            raise ValueError(
                f"{name}: job line {j} must contain exactly {machines} "
                f"(machine, duration) pairs"
            )
        arr = np.asarray(vals, dtype=np.int64).reshape(machines, 2)
        if (arr[:, 0] < 0).any() or (arr[:, 0] >= machines).any():
            raise ValueError(f"{name}: machine id out of range on job {j}")
        if (arr[:, 1] < 0).any():
            raise ValueError(f"{name}: negative duration on job {j}")
        op_machine[j] = arr[:, 0]
        op_dur[j] = arr[:, 1]
    return InstanceSpec(
        name=name,
        num_jobs=jobs,
        num_machines=machines,
        op_machine=op_machine,
        op_dur=op_dur,
    )


def load_instance_file(path: Union[str, os.PathLike]) -> InstanceSpec:
    """Load a Taillard-format instance from a text file path."""
    path = os.fspath(path)
    with open(path, "r") as f:
        text = f.read()
    return parse_taillard_text(text, name=os.path.basename(path))


@dataclasses.dataclass(frozen=True)
class InstanceSet:
    """A stack of instances padded to one common shape (the batchable form)."""

    names: Tuple[str, ...]
    num_jobs: np.ndarray  # (N,) int32
    num_machines: np.ndarray  # (N,) int32
    op_machine: np.ndarray  # (N, J_pad, M_pad) int32
    op_dur: np.ndarray  # (N, J_pad, M_pad) int32

    def __len__(self) -> int:
        return len(self.names)

    @property
    def jobs_pad(self) -> int:
        return self.op_machine.shape[1]

    @property
    def machines_pad(self) -> int:
        return self.op_machine.shape[2]

    def spec(self, key: Union[int, str]) -> InstanceSpec:
        """Extract one instance (unpadded) as an InstanceSpec."""
        i = self.names.index(key) if isinstance(key, str) else int(key)
        nj = int(self.num_jobs[i])
        nm = int(self.num_machines[i])
        return InstanceSpec(
            name=self.names[i],
            num_jobs=nj,
            num_machines=nm,
            op_machine=np.ascontiguousarray(self.op_machine[i, :nj, :nm]),
            op_dur=np.ascontiguousarray(self.op_dur[i, :nj, :nm]),
        )

    def subset(self, keys: Sequence[Union[int, str]]) -> "InstanceSet":
        idx = [self.names.index(k) if isinstance(k, str) else int(k) for k in keys]
        return InstanceSet(
            names=tuple(self.names[i] for i in idx),
            num_jobs=self.num_jobs[idx],
            num_machines=self.num_machines[idx],
            op_machine=self.op_machine[idx],
            op_dur=self.op_dur[idx],
        )


def stack_instances(
    specs: Sequence[InstanceSpec],
    jobs_pad: Optional[int] = None,
    machines_pad: Optional[int] = None,
) -> InstanceSet:
    """Pad a list of specs to a common shape and stack them."""
    if not specs:
        raise ValueError("need at least one instance")
    jp = jobs_pad or max(s.num_jobs for s in specs)
    mp = machines_pad or max(s.num_machines for s in specs)
    padded = [s.padded(jp, mp) for s in specs]
    return InstanceSet(
        names=tuple(s.name for s in specs),
        num_jobs=np.asarray([s.num_jobs for s in specs], dtype=np.int32),
        num_machines=np.asarray([s.num_machines for s in specs], dtype=np.int32),
        op_machine=np.stack([s.op_machine for s in padded]).astype(np.int32),
        op_dur=np.stack([s.op_dur for s in padded]).astype(np.int32),
    )


def save_instance_set(path: Union[str, os.PathLike], iset: InstanceSet) -> None:
    np.savez_compressed(
        os.fspath(path),
        names=np.asarray(iset.names),
        num_jobs=iset.num_jobs,
        num_machines=iset.num_machines,
        op_machine=iset.op_machine,
        op_dur=iset.op_dur,
    )


def load_instance_set(path: Union[str, os.PathLike]) -> InstanceSet:
    with np.load(os.fspath(path), allow_pickle=False) as z:
        return InstanceSet(
            names=tuple(str(n) for n in z["names"]),
            num_jobs=z["num_jobs"].astype(np.int32),
            num_machines=z["num_machines"].astype(np.int32),
            op_machine=z["op_machine"].astype(np.int32),
            op_dur=z["op_dur"].astype(np.int32),
        )


@functools.lru_cache(maxsize=1)
def bundled_instances() -> InstanceSet:
    """The 85 bundled benchmark instances (ta01-ta80 + dmu16-dmu20).

    Mirrors the reference's package-data instance directory
    (JSSEnv/envs/instances/, SURVEY.md §2.1 #18) as one packed npz.
    """
    if not os.path.exists(_BUNDLED_NPZ):
        raise FileNotFoundError(
            f"bundled instance pack not found at {_BUNDLED_NPZ}; "
            "run tools/pack_instances.py to regenerate it"
        )
    return load_instance_set(_BUNDLED_NPZ)


def instance_names() -> Tuple[str, ...]:
    return bundled_instances().names


def get_instance(name_or_path: Union[str, os.PathLike]) -> InstanceSpec:
    """Resolve a bundled instance name (e.g. ``"ta01"``) or a filesystem path.

    This is the single entry point the env config uses, replacing the
    reference's hard-coded ``instance_path`` file handling (jss_env.py:35-39).
    """
    key = os.fspath(name_or_path)
    base = os.path.basename(key)
    try:
        reg = bundled_instances()
    except FileNotFoundError:
        reg = None
    if reg is not None and base in reg.names and not os.path.exists(key):
        return reg.spec(base)
    if os.path.exists(key):
        return load_instance_file(key)
    if reg is not None and base in reg.names:
        return reg.spec(base)
    raise FileNotFoundError(
        f"'{key}' is neither a bundled instance name nor an existing file"
    )


def get_instance_set(
    names: Iterable[Union[str, os.PathLike]],
    jobs_pad: Optional[int] = None,
    machines_pad: Optional[int] = None,
) -> InstanceSet:
    """Build a padded, stacked set from bundled names and/or file paths."""
    specs = [get_instance(n) for n in names]
    return stack_instances(specs, jobs_pad=jobs_pad, machines_pad=machines_pad)


def random_instance(
    num_jobs: int,
    num_machines: int,
    duration_range: Tuple[int, int] = (1, 99),
    seed: int = 0,
    name: Optional[str] = None,
) -> InstanceSpec:
    """Generate a random JSSP instance in the Taillard style: each job visits
    every machine exactly once in a uniformly-random order, with integer
    durations drawn uniformly from ``duration_range`` (inclusive) — the
    distribution Taillard's benchmark generator used. Useful for training-set
    diversity beyond the 85 bundled instances.
    """
    lo, hi = duration_range
    if not (0 < lo <= hi):
        raise ValueError("duration_range must satisfy 0 < lo <= hi")
    rng = np.random.default_rng(seed)
    op_machine = np.stack(
        [rng.permutation(num_machines) for _ in range(num_jobs)]
    ).astype(np.int32)
    op_dur = rng.integers(lo, hi + 1, size=(num_jobs, num_machines)).astype(np.int32)
    return InstanceSpec(
        name=name or f"random_{num_jobs}x{num_machines}_s{seed}",
        num_jobs=num_jobs,
        num_machines=num_machines,
        op_machine=op_machine,
        op_dur=op_dur,
    )


def random_instance_set(
    count: int,
    num_jobs: int,
    num_machines: int,
    duration_range: Tuple[int, int] = (1, 99),
    seed: int = 0,
) -> InstanceSet:
    """A stacked set of ``count`` random instances (seeds seed..seed+count-1)."""
    return stack_instances(
        [
            random_instance(num_jobs, num_machines, duration_range, seed=seed + i)
            for i in range(count)
        ]
    )
