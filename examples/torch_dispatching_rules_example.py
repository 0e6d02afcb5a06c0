#!/usr/bin/env python
"""Compare all dispatching rules on an instance and visualize the results,
with the PyTorch port.

The counterpart of examples/dispatching_rules_example.py: the rule
comparison runs batched on the card (every episode of every rule is a lane
of ``rules.dispatching.compare_rules_batched``), then the best rule's greedy
schedule is rolled on a ``JssEnv`` for the Gantt chart. The charts need
matplotlib (or plotly); without it the comparison still runs and prints.

Usage:
    python examples/torch_dispatching_rules_example.py [instance] [episodes] [device]
    # e.g. python examples/torch_dispatching_rules_example.py ta01 8        (the card)
    #      python examples/torch_dispatching_rules_example.py ta01 8 cpu
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> None:
    instance = sys.argv[1] if len(sys.argv) > 1 else "ta01"
    episodes = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    device = sys.argv[3] if len(sys.argv) > 3 else None

    from jssenv_tpu_torch import instances as inst
    from jssenv_tpu_torch.envs.gym_env import JssEnv
    from jssenv_tpu_torch.rules import dispatching as dsp

    spec = inst.get_instance(instance)
    print(f"instance {spec.name}: {spec.num_jobs} jobs x {spec.num_machines} machines")

    t0 = time.perf_counter()
    results = dsp.compare_rules_batched(spec, num_episodes=episodes, explore_prob=0.1, seed=0, device=device)
    dt = time.perf_counter() - t0
    print(f"\ncompared {len(results)} rules x {episodes} episodes in {dt:.2f}s (batched, {device or 'cuda'})\n")

    ranked = sorted(results.items(), key=lambda kv: kv[1]["avg_makespan"])
    print(f"{'rule':6s} {'avg makespan':>12s} {'avg reward':>11s}")
    for name, r in ranked:
        print(f"{name:6s} {r['avg_makespan']:12.1f} {r['avg_reward']:11.2f}")

    best = ranked[0][0]
    print(f"\nbest rule: {best}; rolling its greedy schedule...")
    config = {"instance_path": instance}
    if device is not None:
        config["device"] = device
    env = JssEnv(config)
    reward, makespan = dsp.get_rule(best).run_episode(env)
    print(f"greedy {best}: makespan {makespan}")
    try:
        fig = env.render()
    except ImportError:  # neither plotly nor matplotlib: no charts
        fig = None
        print("no plotting library installed: charts skipped")
    if fig is not None:
        out = f"{instance}_{best}_gantt.png"
        if hasattr(fig, "savefig"):
            fig.savefig(out, dpi=100)
        else:  # plotly
            fig.write_image(out)
        print(f"Gantt saved to {out}")
        try:
            import matplotlib
        except ImportError:
            matplotlib = None
        if matplotlib is not None:
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            figb, ax = plt.subplots(figsize=(7, 4))
            ax.bar([n for n, _ in ranked], [r["avg_makespan"] for _, r in ranked])
            ax.set_ylabel("avg makespan")
            ax.set_title(f"Dispatching rules on {instance} ({episodes} episodes)")
            chart = f"{instance}_rules_comparison.png"
            figb.tight_layout()
            figb.savefig(chart, dpi=100)
            print(f"comparison chart saved to {chart}")

    # the step-by-step SPT trace of the reference example, through the
    # reference-compatible attribute surface of the wrapper
    print("\nExample of using a dispatching rule directly:")
    print("-" * 60)
    rule = dsp.DISPATCHING_RULES["SPT"]
    print(f"Rule: {rule.get_name()} - {rule.get_description()}")
    env.reset()
    done = False
    steps = 0
    total_reward = 0.0
    while not done and steps < 10:  # only show the first 10 steps
        action = rule(env)
        if steps < 5:  # details only for the first 5
            print(f"Step {steps}: Selected job {action}")
            legal_actions = env.get_legal_actions()
            print(f"  Legal actions: {int(np.sum(legal_actions[:-1]))}")
            for job in range(env.jobs):
                if legal_actions[job]:
                    current_op = env.todo_time_step_job[job]
                    process_time = env.instance_matrix[job][current_op][1]
                    print(f"  Job {job}: Processing time = {process_time}")
        _, reward, done, _, _ = env.step(action)
        total_reward += reward
        steps += 1
    print("...")  # more steps would follow
    print(f"Episode finished with reward {total_reward:.2f} and makespan {env.current_time_step}")


if __name__ == "__main__":
    main()
