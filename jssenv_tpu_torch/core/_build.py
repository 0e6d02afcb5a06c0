"""Build the CUDA sources of ``csrc/`` with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``jssenv_tpu_torch/build/lib<name>_<hash>.so`` (the hash covers the
source, the headers of ``csrc/`` and the flags, so an edited source or
header is rebuilt). ``-Xptxas -v`` output
(registers, spills) is kept beside the library as ``.log``. Nothing is built
or imported at module import time.

A source may also be built for one static shape ``(J, M)``: ``nvcc`` gets
``-DJSS_STATIC_J=J -DJSS_STATIC_M=M`` and the library is
``lib<name>_<J>x<M>_<hash>.so``, one for each shape met
(``csrc/driven_static.cu`` and ``csrc/free_static.cu`` build for a shape
only; ``csrc/rollout.cu``'s static variant is its instrumented build).
``shape=None`` is the general build. ``defines`` (``("JSS_PASS_CLOCKS",)``)
build a variant of its own, named after them: the instrumented builds that
count each pass's clocks.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


Shape = Optional[Tuple[int, int]]
Defines = Tuple[str, ...]


def nvcc_flags(shape: Shape = None, defines: Defines = ()) -> Tuple[str, ...]:
    """The flags of the general build, or of the static build of ``shape``,
    with ``defines`` added."""
    extra = tuple(f"-D{d}" for d in defines)
    if shape is None:
        return NVCC_FLAGS + extra
    J, M = (int(x) for x in shape)
    if J < 1 or M < 1:
        raise ValueError(f"a static build needs a positive shape, got {shape}")
    return NVCC_FLAGS + (f"-DJSS_STATIC_J={J}", f"-DJSS_STATIC_M={M}") + extra


def library_path(name: str, shape: Shape = None, defines: Defines = ()) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(nvcc_flags(shape, defines)).encode()).hexdigest()[:16]
    tag = name if shape is None else f"{name}_{shape[0]}x{shape[1]}"
    tag += "".join("_" + d.lower().removeprefix("jss_").replace("=", "") for d in defines)
    return BUILD_DIR / f"lib{tag}_{digest}.so"


Job = Tuple  # (name, shape) or (name, shape, defines)


def build_jobs(jobs: Iterable[Job]) -> Dict[Job, Path]:
    """Compile every (source name, shape[, defines]) that is not built yet,
    all nvcc processes started together; returns job -> library path.
    Raises with the compiler's output if a build fails. Each process writes
    its own temporary file and renames it into place, so several processes
    may build one library at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {job: library_path(*job) for job in dict.fromkeys(jobs)}
    procs = {}
    for job, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(*job[1:]), "-o", str(tmp), str(CSRC / f"{job[0]}.cu")]
        procs[job] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    for job, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            what = "" if job[1] is None else f" for the static shape {job[1]}"
            what += f" with {' '.join(job[2])}" if len(job) > 2 and job[2] else ""
            raise RuntimeError(f"nvcc failed on csrc/{job[0]}.cu{what}:\n{log}")
        out[job].with_suffix(".log").write_text(log)
        os.replace(tmp, out[job])
    return out


def build(names: Sequence[str], shapes: Sequence[Shape] = (None,)) -> Dict[Tuple[str, Shape], Path]:
    """Every named source for every shape (``None``: the general build), as
    ``build_jobs``; returns (name, shape) -> library path."""
    return build_jobs((n, s) for n in names for s in shapes)


def ptxas_report(name: str, shape: Shape = None, defines: Defines = ()) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name`` for ``shape``, or "" if it was built by another
    process."""
    log = library_path(name, shape, defines).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(
        ln for ln in log.read_text().splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    )


@functools.lru_cache(maxsize=None)
def load(name: str, shape: Shape = None, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` for ``shape``, built first if
    needed."""
    job = (name, shape, tuple(defines)) if defines else (name, shape)
    return ctypes.CDLL(str(build_jobs([job])[job]))
