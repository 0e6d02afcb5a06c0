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
                           PyTorch twins used for CPU tensors;
* ``native``             — the scalar C++ single-env engine (built with g++
                           at first use);
* ``replay``             — machine-order schedule replay;
* ``rules.dispatching``  — the seven dispatching rules, batched;
* ``envs.gym_env``       — ``JssEnv``, the reference-compatible Gym wrapper;
* ``envs.vec_env``       — ``JssVectorEnv``, B lockstep envs behind one object;
* ``render.gantt``       — Gantt charts of a schedule;
* ``utils``              — ``create_env``, ``assign_env_config``, ``RunSettings``;
* ``models.policy``      — ``MaskedPolicyNet``, ``PerJobPolicyNet``, ``sample_action``;
* ``checkpoint``         — the JAX package's npz checkpoints, flax weights
                           carried into the port's nets and back, whole
                           TrainStates, and sharded checkpoints over
                           ``torch.distributed.checkpoint``;
* ``parallel.learner``   — the actor-learner (REINFORCE, PPO; data and
                           tensor parallel) and greedy or sampled
                           evaluation, every env step in the driven kernel
                           on the card;
* ``parallel.mesh``      — dp x mp process meshes, sharded batches and
                           rollouts;
* ``parallel.multihost`` — joining the process group (NCCL, or gloo by name)
                           and per-rank lanes of a global batch;
* ``distill``            — teacher pairs from rules or schedules, and
                           cross-entropy pretraining of a policy;
* ``diagnostics``        — a profiler window, host spans and counters of
                           the learner and the rollouts, and state
                           invariant checks;
* ``anneal``             — order-space evaluation of machine orders, simulated
                           annealing and tabu search;
* ``solve``              — the schedule solver: noisy dispatching rollouts,
                           refined by ``anneal`` and certified by replay.

Entry points place state on the CUDA card unless ``device="cpu"`` is given;
without a card they raise instead of falling back to the CPU.

Importing this package registers the ``"jss-torch-v1"`` environment with
gymnasium, when gymnasium is installed (``"jss-v1"`` is the JAX package's).
"""

__version__ = "0.1.0"

from jssenv_tpu_torch import instances, utils  # noqa: F401
from jssenv_tpu_torch.instances import (  # noqa: F401
    InstanceSet,
    InstanceSpec,
    bundled_instances,
    get_instance,
    get_instance_set,
    load_instance_file,
    parse_taillard_text,
)

try:
    from gymnasium.envs.registration import register, registry

    if "jss-torch-v1" not in registry:
        register(id="jss-torch-v1", entry_point="jssenv_tpu_torch.envs.gym_env:JssEnv")
except ImportError:  # pragma: no cover - gymnasium optional
    pass
