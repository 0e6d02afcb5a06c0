#!/usr/bin/env python
"""Train the masked-policy network with the PyTorch port's sharded actor-learner.

Usage:
    torchrun --nproc-per-node=N examples/torch_train_policy.py [instance] [batch] [updates] [mp]
    python examples/torch_train_policy.py [instance] [batch] [updates]   # one card

One process per card over NCCL (``multihost.initialize`` reads torchrun's
environment). The global env batch splits over the ``dp`` ranks; with
``mp`` > 1 the net's two hidden layers split over ``mp`` ranks as well
(N = dp * mp). Rank 0 then runs a greedy evaluation with 63 sampled lanes
beside it and saves the policy in the JAX package's npz format
(``jssenv_tpu.checkpoint.load`` reads it).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    instance = sys.argv[1] if len(sys.argv) > 1 else "ta01"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    updates = int(sys.argv[3]) if len(sys.argv) > 3 else 200
    mp = int(sys.argv[4]) if len(sys.argv) > 4 else 1

    import torch
    import torch.distributed as dist

    from jssenv_tpu_torch import checkpoint, instances as inst
    from jssenv_tpu_torch.parallel import learner, mesh as meshlib, multihost

    multihost.initialize()
    m = meshlib.make_mesh(mp=mp)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    log = print if rank0 else (lambda *_: None)
    log(f"ranks: {m.size} (dp {m.dp} x mp {m.mp}) on {torch.cuda.get_device_name(m.device)}")

    spec = inst.get_instance(instance)
    config = learner.LearnerConfig(unroll_steps=32, hidden=(256, 256))
    ts, _ = learner.train(spec, batch_size=batch, num_updates=updates, config=config, mesh=m,
                          log_every=max(1, updates // 20), log_fn=log)
    params = learner.gather_params(ts.model, m)  # every rank takes part
    if rank0:
        # deterministic outcome metric, comparable 1:1 with the greedy rules
        r = learner.evaluate_policy(params, spec, config, stochastic_lanes=63, device=m.device)
        print(f"greedy-argmax makespan: {r['greedy_makespan']}  "
              f"(best of 63 sampled lanes: {r['best_sampled_makespan']})")
        out = f"{instance}_policy.npz"
        checkpoint.save(out, checkpoint.params_to_flax(params))
        print(f"saved trained policy params to {out}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
