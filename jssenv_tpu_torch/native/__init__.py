"""ctypes bindings + build-on-demand for the native single-env engine.

The PyTorch port's copy of ``jssenv_tpu/native``: the same C++ engine
(``jss_engine.cpp``) and the same Python surface (``load``,
``NativeEngine``, ``NativeUnavailableError``). The shared library is compiled
with ``g++ -O3`` at first use into ``jssenv_tpu_torch/build/`` (named by a
hash of the source, so an edited source is rebuilt), never next to the
source. If no compiler is available, ``load()`` returns None and
``NativeEngine`` raises ``NativeUnavailableError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "jss_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# no -march=native (unlike the JAX package's build): a library built on one
# host must load on another that is handed the same checkout
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class NativeUnavailableError(RuntimeError):
    """The native library could not be built/loaded (no compiler, bad .so).

    Distinct from real native-engine runtime failures so 'auto' fallbacks can
    catch exactly this and let genuine engine errors propagate."""


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libjss_engine_{digest}.so"


def _build(out_path: Path) -> bool:
    """Compile into a private temporary name, then rename: processes that
    build at once (test workers) never load a half-written library."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_name(f"{out_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0 or not tmp.exists():
        return False
    os.replace(tmp, out_path)
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native engine; None when unavailable."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        path = library_path()
        if not path.exists() and not _build(path):
            _LOAD_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _LOAD_FAILED = True
            return None
        _declare(lib)
        _LIB = lib
        return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    c_i32, c_u8 = ctypes.c_int32, ctypes.c_uint8
    p_i32 = ctypes.POINTER(c_i32)
    p_u8 = ctypes.POINTER(c_u8)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    H = ctypes.c_void_p
    lib.jss_create.restype = H
    lib.jss_create.argtypes = [c_i32, c_i32, p_i32, p_i32]
    lib.jss_destroy.argtypes = [H]
    lib.jss_reset.argtypes = [H]
    lib.jss_step.restype = c_i32
    lib.jss_step.argtypes = [H, c_i32, p_u8]
    lib.jss_advance_time.restype = c_i32
    lib.jss_advance_time.argtypes = [H]
    for name in ("jss_time", "jss_nb_legal", "jss_nb_machine_legal", "jss_max_time_op"):
        getattr(lib, name).restype = c_i32
        getattr(lib, name).argtypes = [H]
    lib.jss_noop_legal.restype = c_u8
    lib.jss_noop_legal.argtypes = [H]
    for name in (
        "jss_machine_busy_for", "jss_job_busy_for", "jss_next_op",
        "jss_work_done", "jss_needed_machine", "jss_idle_total",
        "jss_idle_since_op", "jss_solution",
    ):
        getattr(lib, name).restype = p_i32
        getattr(lib, name).argtypes = [H]
    for name in ("jss_legal", "jss_machine_legal_arr", "jss_pin", "jss_noop_pin"):
        getattr(lib, name).restype = p_u8
        getattr(lib, name).argtypes = [H]
    lib.jss_obs.restype = p_f32
    lib.jss_obs.argtypes = [H]


class NativeEngine:
    """Object wrapper over the C engine with zero-copy numpy state views."""

    def __init__(self, op_machine: np.ndarray, op_dur: np.ndarray):
        lib = load()
        if lib is None:
            raise NativeUnavailableError("native engine unavailable (no compiler?)")
        self._lib = lib
        om = np.ascontiguousarray(op_machine, dtype=np.int32)
        od = np.ascontiguousarray(op_dur, dtype=np.int32)
        self.jobs, self.machines = om.shape
        self._h = lib.jss_create(
            self.jobs,
            self.machines,
            om.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            od.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        J, M = self.jobs, self.machines

        def view(ptr, shape, dtype):
            n = int(np.prod(shape))
            buf = np.ctypeslib.as_array(ptr, shape=(n,))
            return buf.view(dtype).reshape(shape)

        self.legal = view(lib.jss_legal(self._h), (J,), np.uint8)
        self.machine_legal = view(lib.jss_machine_legal_arr(self._h), (M,), np.uint8)
        self.machine_busy_for = view(lib.jss_machine_busy_for(self._h), (M,), np.int32)
        self.job_busy_for = view(lib.jss_job_busy_for(self._h), (J,), np.int32)
        self.next_op = view(lib.jss_next_op(self._h), (J,), np.int32)
        self.work_done = view(lib.jss_work_done(self._h), (J,), np.int32)
        self.needed_machine = view(lib.jss_needed_machine(self._h), (J,), np.int32)
        self.idle_total = view(lib.jss_idle_total(self._h), (J,), np.int32)
        self.idle_since_op = view(lib.jss_idle_since_op(self._h), (J,), np.int32)
        self.pin = view(lib.jss_pin(self._h), (M, J), np.uint8)
        self.noop_pin = view(lib.jss_noop_pin(self._h), (J,), np.uint8)
        self.solution = view(lib.jss_solution(self._h), (J, M), np.int32)
        self.obs = view(lib.jss_obs(self._h), (J, 7), np.float32)
        self._done_out = ctypes.c_uint8(0)
        self.reset()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.jss_destroy(h)
            self._h = None

    # --- scalars ---
    @property
    def time(self) -> int:
        return self._lib.jss_time(self._h)

    @property
    def nb_legal(self) -> int:
        return self._lib.jss_nb_legal(self._h)

    @property
    def nb_machine_legal(self) -> int:
        return self._lib.jss_nb_machine_legal(self._h)

    @property
    def noop_legal(self) -> bool:
        return bool(self._lib.jss_noop_legal(self._h))

    @property
    def max_time_op(self) -> int:
        return self._lib.jss_max_time_op(self._h)

    # --- api ---
    def reset(self) -> None:
        self._lib.jss_reset(self._h)

    def step(self, action: int):
        """Returns (raw_reward int, done bool)."""
        r = self._lib.jss_step(self._h, int(action), ctypes.byref(self._done_out))
        return int(r), bool(self._done_out.value)

    def advance_time(self) -> int:
        return int(self._lib.jss_advance_time(self._h))
