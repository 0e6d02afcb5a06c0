"""jssenv_tpu_torch: the job-shop scheduling environment engine in PyTorch + CUDA.

A port of ``jssenv_tpu`` (JAX) to PyTorch, with the fused auto-resetting
rollout written as hand-made CUDA kernels for NVIDIA Hopper
(``core/csrc/rollout.cu``). The module names mirror the JAX package:

* ``instances``          — Taillard parsing and the 85 bundled instances;
* ``core.state``         — ``EnvState``, a dataclass of batch-first tensors;
* ``core.ops``           — gather / segment-reduce primitives;
* ``core.engine``        — reset / advance_time / fast_forward / step;
* ``vector``             — ``make_batch``, ``step_autoreset``, ``rollout``;
* ``core.fused_rollout`` — the whole rollout in one CUDA launch, with plain
                           PyTorch twins used for CPU tensors.

Entry points place state on the CUDA card unless ``device="cpu"`` is given;
without a card they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"

from jssenv_tpu_torch import instances  # noqa: F401
from jssenv_tpu_torch.instances import (  # noqa: F401
    InstanceSet,
    InstanceSpec,
    bundled_instances,
    get_instance,
    get_instance_set,
    load_instance_file,
    parse_taillard_text,
)
