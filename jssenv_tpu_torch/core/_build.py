"""Build the CUDA sources of ``csrc/`` with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``jssenv_tpu_torch/build/lib<name>_<hash>.so`` (the hash covers the
source and the flags, so an edited source is rebuilt). ``-Xptxas -v`` output
(registers, spills) is kept beside the library as ``.log``. Nothing is built
or imported at module import time.

A source may also be built for one static shape ``(J, M)``: ``nvcc`` gets
``-DJSS_STATIC_J=J -DJSS_STATIC_M=M`` and the library is
``lib<name>_<J>x<M>_<hash>.so``, one for each shape met (``csrc/rollout.cu``'s
static variant). ``shape=None`` is the general build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

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


def nvcc_flags(shape: Shape = None) -> Tuple[str, ...]:
    """The flags of the general build, or of the static build of ``shape``."""
    if shape is None:
        return NVCC_FLAGS
    J, M = (int(x) for x in shape)
    if J < 1 or M < 1:
        raise ValueError(f"a static build needs a positive shape, got {shape}")
    return NVCC_FLAGS + (f"-DJSS_STATIC_J={J}", f"-DJSS_STATIC_M={M}")


def library_path(name: str, shape: Shape = None) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(shape)).encode()).hexdigest()[:16]
    tag = name if shape is None else f"{name}_{shape[0]}x{shape[1]}"
    return BUILD_DIR / f"lib{tag}_{digest}.so"


def build(names: Sequence[str], shapes: Sequence[Shape] = (None,)) -> Dict[Tuple[str, Shape], Path]:
    """Compile every named source for every shape (``None``: the general
    build) that is not built yet, all nvcc processes started together;
    returns (name, shape) -> library path. Raises with the compiler's output
    if a build fails. Each process writes its own temporary file and renames
    it into place, so several processes may build one library at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {(n, s): library_path(n, s) for n in names for s in dict.fromkeys(shapes)}
    procs = {}
    for (n, s), lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(s), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n, s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    for key, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            what = "" if key[1] is None else f" for the static shape {key[1]}"
            raise RuntimeError(f"nvcc failed on csrc/{key[0]}.cu{what}:\n{log}")
        out[key].with_suffix(".log").write_text(log)
        os.replace(tmp, out[key])
    return out


def ptxas_report(name: str, shape: Shape = None) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name`` for ``shape``, or "" if it was built by another
    process."""
    log = library_path(name, shape).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(
        ln for ln in log.read_text().splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    )


@functools.lru_cache(maxsize=None)
def load(name: str, shape: Shape = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` for ``shape``, built first if
    needed."""
    return ctypes.CDLL(str(build([name], [shape])[name, shape]))
