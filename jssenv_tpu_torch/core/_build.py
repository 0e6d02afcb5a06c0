"""Build the CUDA sources of ``csrc/`` with ``nvcc`` at first use; bind with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``jssenv_tpu_torch/build/lib<name>_<hash>.so`` (the hash covers the
source and the flags, so an edited source is rebuilt). ``-Xptxas -v`` output
(registers, spills) is kept beside the library as ``.log``. Nothing is built
or imported at module import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

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


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc processes
    started together; returns name -> library path. Raises with the
    compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for n, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
        out[n].with_suffix(".log").write_text(log)
        os.replace(tmp, out[n])
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name``, or "" if it was built by another process."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(
        ln for ln in log.read_text().splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    )


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
