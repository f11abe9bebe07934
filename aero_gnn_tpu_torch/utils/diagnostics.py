"""Graph structure diagnostics: adjacency spy plot, degree histogram, stats
(counterpart of aero_gnn_tpu.utils.diagnostics). matplotlib is imported
only by the plots, when they are called."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def graph_statistics(senders: np.ndarray, receivers: np.ndarray,
                     num_nodes: Optional[int] = None) -> Dict[str, float]:
    if num_nodes is None:
        num_nodes = int(max(senders.max(), receivers.max())) + 1
    num_edges = len(senders)
    total_possible = num_nodes * num_nodes
    degrees = np.bincount(senders, minlength=num_nodes)
    pairs = set(zip(senders.tolist(), receivers.tolist()))
    undirected = all((b, a) in pairs for (a, b) in pairs)
    return {
        "num_nodes": num_nodes,
        "num_edges": num_edges,
        "undirected": bool(undirected),
        "sparsity": 1.0 - num_edges / total_possible,
        "density": num_edges / total_possible,
        "avg_degree": float(degrees.mean()),
        "max_degree": int(degrees.max()),
        "min_degree": int(degrees.min()),
    }


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_adjacency_matrix(senders, receivers, num_nodes=None,
                          title="Graph Adjacency Matrix",
                          save_path=None, max_display_nodes=100_000):
    plt = _mpl()
    if num_nodes is None:
        num_nodes = int(max(senders.max(), receivers.max())) + 1
    s, r = np.asarray(senders), np.asarray(receivers)
    if num_nodes > max_display_nodes:
        keep = np.sort(np.random.choice(num_nodes, max_display_nodes,
                                        replace=False))
        remap = -np.ones(num_nodes, dtype=np.int64)
        remap[keep] = np.arange(max_display_nodes)
        m = (remap[s] >= 0) & (remap[r] >= 0)
        s, r = remap[s[m]], remap[r[m]]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(r, s, s=1, color="steelblue", marker=".")
    ax.invert_yaxis()
    ax.set_xlabel("Node Index")
    ax.set_ylabel("Node Index")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_degree_distribution(senders, num_nodes=None,
                             title="Node Degree Distribution",
                             save_path=None):
    plt = _mpl()
    if num_nodes is None:
        num_nodes = int(senders.max()) + 1
    degrees = np.bincount(np.asarray(senders), minlength=num_nodes)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.hist(degrees, bins=min(50, num_nodes), color="steelblue",
            alpha=0.7, edgecolor="black")
    ax.set_xlabel("Node Degree")
    ax.set_ylabel("Frequency")
    ax.set_title(title)
    ax.grid(True, alpha=0.3, linestyle="--")
    stats = (f"Mean: {degrees.mean():.2f}\nMax: {degrees.max()}\n"
             f"Min: {degrees.min()}")
    ax.text(0.97, 0.97, stats, transform=ax.transAxes,
            va="top", ha="right",
            bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5))
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_graph_sparsity(senders, receivers, num_nodes=None,
                        title="Graph", save_path="graph"):
    """Adjacency and degree plots and a statistics text file:
    ``<save_path>_adjacency.png``, ``_degree_dist.png``,
    ``_statistics.txt``."""
    base = os.path.splitext(save_path)[0]
    plot_adjacency_matrix(senders, receivers, num_nodes,
                          f"{title} - Adjacency Matrix",
                          f"{base}_adjacency.png")
    plot_degree_distribution(senders, num_nodes,
                             f"{title} - Degree Distribution",
                             f"{base}_degree_dist.png")
    stats = graph_statistics(np.asarray(senders), np.asarray(receivers),
                             num_nodes)
    with open(f"{base}_statistics.txt", "w") as f:
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")
