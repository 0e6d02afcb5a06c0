#!/usr/bin/env python
"""How ``core/csrc/rollout.cu``'s wider machine-slot classes trade spills
against resident warps, on the card.

The general build holds every class under ``__launch_bounds__(256,
JSS_MIN_BLOCKS)`` with five blocks an SM (48 registers a thread); at three
and four machine slots ptxas spills there. This builds the classes of three
and four machine slots once more with four and with three blocks an SM (a
copy of the source with ``JSS_MIN_BLOCKS`` changed, under
``jssenv_tpu_torch/build/min_blocks/``), prints each variant's ``-Xptxas
-v``, and times every variant on ``chip_smoke.py``'s ``WIDE`` configs (the
free kernel at their B and T, the driven kernel at the wide policy loop's
T=1 step with ends) in turns (5, 4, 3, 3, 4, 5), after holding each
variant's results equal to the repo build's on the same inputs. It prints
one line a case and the card's name and power limit; ``--out FILE`` writes
the times as JSON. Without a card it exits 1.

Usage:
    python tools/rollout_min_blocks_torch.py [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = (4, 3)  # blocks an SM besides the source's 5
CLASSES = (3, 4)  # the machine-slot classes of the WIDE configs


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of a ``rollout.cu`` library, as ``fused_rollout._lib``
    declares them."""
    P, I = ctypes.c_void_p, ctypes.c_int
    geometry = [I, I, I, I]
    lib.jss_rollout_driven.argtypes = [P, P, P, P, P, P, I, I, I, I, I, *geometry, P]
    lib.jss_rollout_driven.restype = I
    for fn in (lib.jss_rollout_free, lib.jss_rollout_free_i16):
        fn.argtypes = [P, P, P, P, ctypes.c_ulonglong, P, P, I, I, I, I, I, *geometry, P]
        fn.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the times to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rollout_min_blocks_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from jssenv_tpu_torch import instances, vector
    from jssenv_tpu_torch.core import _build, fused_rollout as fr

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    src = (_build.CSRC / "rollout.cu").read_text()
    line = "#define JSS_MIN_BLOCKS 5"
    if src.count(line) != 1:
        raise RuntimeError(f"rollout.cu no longer has one '{line}'")
    work = _build.BUILD_DIR / "min_blocks"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for mb in VARIANTS:
        cu = work / f"rollout_min_blocks{mb}.cu"
        cu.write_text(src.replace(line, f"#define JSS_MIN_BLOCKS {mb}"))
        for k in CLASSES:
            so = work / f"librollout_min_blocks{mb}_m{k}.so"
            cmd = [_build._nvcc(), *_build.nvcc_flags(None, fr.rollout_defines(k)), "-o", str(so), str(cu)]
            procs.append(((mb, k), so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                        text=True)))
    fr.build_kernels([fr.Build("rollout", k) for k in CLASSES])
    libs = {5: {k: fr._lib(k) for k in CLASSES}}
    for (mb, k), so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {mb}-block variant of class {k}:\n{log}")
        print(f"ptxas JSS_MIN_BLOCKS={mb}, {k} machine slots:\n"
              + "\n".join(ln for ln in log.splitlines() if "registers" in ln or "spill" in ln), flush=True)
        libs.setdefault(mb, {})[k] = _declare(ctypes.CDLL(str(so)))
    repo_lib = fr._lib

    def use(mb):
        fr._lib = repo_lib if mb == 5 else (lambda slots=2: libs[mb][slots])

    res = {}
    cases = [("rollout_free", n, B, T) for n, B, T in smoke.WIDE] + [("rollout_driven",) + smoke.WIDE_LOOP[:2] + (1,)]
    try:
        for kernel, name, B, T in cases:
            state = vector.make_batch(smoke.source(instances, name), B, device=dev)
            vdt, acts = fr.value_dtype(state) if kernel == "rollout_free" else torch.int32, None
            if kernel == "rollout_driven":  # the wide policy loop's last step
                gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
                for _ in range(smoke.WIDE_LOOP[2] - 1):
                    state, _ = fr.rollout_driven(state, vector.random_legal_actions(gen, state)[None], 1)
                acts = vector.random_legal_actions(gen, state)[None].to(torch.int32).contiguous()
            got = {}
            for mb in (5, *VARIANTS):
                use(mb)
                got[mb] = (fr._free_kernel(state, T, smoke.SEED, None, vdt) if acts is None
                           else dict(zip(("rewards", "ends"), fr._driven_kernel(state, acts, 1, True, True)[1:])))
            for mb in VARIANTS:
                if not all(torch.equal(got[mb][f], got[5][f]) for f in got[5]):
                    raise RuntimeError(f"{kernel} {name}: the {mb}-block variant differs from the repo build")
            row = {}
            for mb in (5, *VARIANTS, *reversed(VARIANTS), 5):
                use(mb)
                row.setdefault(mb, []).append(smoke.launch_timer(
                    fr, dev, kernel, state, T, actions=acts, vdt=vdt, ends=acts is not None,
                    repeats=5 if acts is None else 20)["ms"])
            res[f"{kernel} {name}"] = row
            print(f"{kernel} {name} B={B} T={T}: " + ", ".join(
                f"JSS_MIN_BLOCKS={mb} {v[0]:.4f}, {v[1]:.4f} ms ({sum(v) / sum(row[5]):.4f}x)" for mb, v in row.items()),
                flush=True)
    finally:
        use(5)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if args.out:
        Path(args.out).write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
