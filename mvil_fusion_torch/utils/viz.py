"""Offline observability plots.

Counterpart of ``mvil_fusion_tpu/utils/viz.py``, a numpy copy.  matplotlib
is imported only inside a plot function, so nothing else needs it.

The reference's telemetry is RViz: constraint-mode colour markers
(white/green/red/blue/purple legend, config/mynteye_leishen_indoor.yaml:136,
visualization.cpp pubLidarICPConstraintMarker :250-333), factor-graph text
markers and depth-coloured feature overlays (SURVEY.md §5).  Headless here:
the same signals render to PNG via matplotlib.
"""

from __future__ import annotations

import numpy as np

# reference marker legend (estimator constraint modes)
MODE_COLORS = {
    0: "#bbbbbb",   # off
    1: "#ffffff",   # icp fail (white)
    2: "#2ca02c",   # VIO good (green)
    3: "#d62728",   # VIO drift (red)
    4: "#1f77b4",   # zero velocity (blue)
    5: "#9467bd",   # pure rotation (purple)
}


def plot_trajectories(path: str, named_trajs: dict, gt=None,
                      modes: list | None = None):
    """Top-down (x,y) trajectory comparison; optional ground truth and
    per-sweep constraint-mode dots."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    if gt is not None:
        g = np.asarray([p for (_, p, *_) in gt])
        ax.plot(g[:, 0], g[:, 1], "k--", lw=1, label="ground truth")
    for name, rows in named_trajs.items():
        if not rows:
            continue
        p = np.asarray([r[1] for r in rows])
        ax.plot(p[:, 0], p[:, 1], lw=1.2, label=name)
    if modes:
        for (x, y, m) in modes:
            ax.scatter([x], [y], c=MODE_COLORS.get(m, "#000000"), s=12,
                       zorder=5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def plot_map(path: str, pts: np.ndarray, traj=None, max_pts: int = 60000):
    """Top-down global map scatter (the Map.pcd view) + trajectory."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    p = np.asarray(pts)
    if len(p) > max_pts:
        sel = np.random.default_rng(0).choice(len(p), max_pts, replace=False)
        p = p[sel]
    if len(p):
        ax.scatter(p[:, 0], p[:, 1], s=0.3, c=p[:, 2], cmap="viridis",
                   alpha=0.6)
    if traj:
        t = np.asarray([r[1] for r in traj])
        ax.plot(t[:, 0], t[:, 1], "r-", lw=1.5, label="trajectory")
        ax.legend(loc="best", fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.axis("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
