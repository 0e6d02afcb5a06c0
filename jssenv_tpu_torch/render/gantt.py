"""Host-side Gantt rendering of schedules (the observability layer).

The reference renders via pandas + plotly.figure_factory.create_gantt with a
kaleido subprocess for GIF frames (reference: jss_env.py:655-693, README GIF
workflow). Rendering stays host-side here by design (SURVEY.md §5.5): the
device hands back only the ``solution`` start-time matrix. Two backends:

* plotly (if installed): same create_gantt figure as the reference;
* matplotlib (always available here): an equivalent broken-bar Gantt.

``schedule_frames_gif`` reproduces the reference README's GIF recipe without
kaleido by rasterizing matplotlib frames through imageio.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np


def schedule_records(
    solution: np.ndarray,
    op_machine: np.ndarray,
    op_dur: np.ndarray,
    start_timestamp: float = 0.0,
) -> List[dict]:
    """Flatten a solution matrix into Task/Start/Finish/Resource records.

    Matches the reference's dataframe schema (jss_env.py:666-677): one record
    per scheduled op, wall-clock anchored at ``start_timestamp``, stopping at
    the first unscheduled op of each job.
    """
    records = []
    jobs, machines = solution.shape
    for job in range(jobs):
        for k in range(machines):
            if solution[job][k] == -1:
                break
            start = start_timestamp + int(solution[job][k])
            finish = start + int(op_dur[job][k])
            records.append(
                {
                    "Task": f"Job {job}",
                    "Start": datetime.datetime.fromtimestamp(start),
                    "Finish": datetime.datetime.fromtimestamp(finish),
                    "Resource": f"Machine {int(op_machine[job][k])}",
                }
            )
    return records


def render_schedule(
    solution: np.ndarray,
    op_machine: np.ndarray,
    op_dur: np.ndarray,
    colors: Optional[Sequence[Tuple[float, float, float]]] = None,
    start_timestamp: float = 0.0,
    backend: str = "auto",
):
    """Render the schedule as a Gantt figure; None if nothing is scheduled."""
    records = schedule_records(solution, op_machine, op_dur, start_timestamp)
    if not records:
        return None
    machines = int(op_machine.max()) + 1
    if colors is None:
        rng = np.random.default_rng(0)
        colors = [tuple(rng.uniform(size=3)) for _ in range(machines)]
    if backend in ("auto", "plotly"):
        try:
            return _render_plotly(records, colors)
        except (ImportError, AttributeError):
            # AttributeError covers stubbed/partial plotly installs
            if backend == "plotly":
                raise
    return _render_matplotlib(solution, op_machine, op_dur, colors)


def _render_plotly(records, colors):
    import pandas as pd
    import plotly.figure_factory as ff

    df = pd.DataFrame(records)
    fig = ff.create_gantt(
        df,
        index_col="Resource",
        colors=list(colors),
        show_colorbar=True,
        group_tasks=True,
    )
    fig.update_yaxes(autorange="reversed")
    return fig


def _render_matplotlib(solution, op_machine, op_dur, colors):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    jobs, machines = solution.shape
    fig, ax = plt.subplots(figsize=(12, max(3, 0.3 * jobs)))
    for job in range(jobs):
        for k in range(machines):
            if solution[job][k] == -1:
                break
            m = int(op_machine[job][k])
            ax.barh(
                y=job,
                width=int(op_dur[job][k]),
                left=int(solution[job][k]),
                height=0.8,
                color=colors[m % len(colors)],
                edgecolor="black",
                linewidth=0.3,
            )
    ax.set_xlabel("time")
    ax.set_ylabel("job")
    ax.set_yticks(range(jobs))
    ax.invert_yaxis()
    handles = [
        mpatches.Patch(color=colors[m % len(colors)], label=f"Machine {m}")
        for m in range(machines)
    ]
    ax.legend(
        handles=handles, loc="center left", bbox_to_anchor=(1.0, 0.5), fontsize=7
    )
    fig.tight_layout()
    return fig


def figure_to_rgb(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to an (H, W, 3) uint8 array."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def schedule_frames_gif(
    frames: List[np.ndarray],
    path: str,
    fps: int = 2,
) -> None:
    """Write rasterized frames to a GIF (reference README's imageio workflow,
    minus the kaleido subprocess)."""
    import imageio

    imageio.mimsave(path, frames, duration=1000.0 / fps)
