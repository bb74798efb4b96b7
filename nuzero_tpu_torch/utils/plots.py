"""Offline plotting from the metrics journal (counterpart of
``nuzero_tpu/utils/plots.py``: the same functions, file names and series).

Replaces the reference's in-loop matplotlib rendering
(ref ``Training/AlphaZero.py:963-1251``: global/recent loss scatter,
win-rate curves for 4 test types x 2 seats, weight stats) and the offline
``Plots/PlotMaker.py`` (win-rate vs recurrent-iteration extrapolation
curves with flat baselines).  Plotting never runs in the training hot
loop: it reads the JSONL journal after the fact.

matplotlib is an optional dependency here: it is imported (Agg backend) at
the first call, never at module import.  Where it is not installed, every
call writes nothing and returns ``[]``, and the first call of the process
warns (``MissingMatplotlibWarning``) with a message that names it.  Each
function returns the paths it wrote.
"""

from __future__ import annotations

import functools
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple


class MissingMatplotlibWarning(UserWarning):
    """No plot was drawn: matplotlib is not installed."""


@functools.lru_cache(maxsize=None)
def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None (after one warning
    per process) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        warnings.warn("matplotlib is not installed: no plots are drawn",
                      MissingMatplotlibWarning, stacklevel=3)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _series(records: List[Dict], key: str) -> Tuple[List[int], List[float]]:
    xs, ys = [], []
    for r in records:
        if key in r and r[key] is not None:
            xs.append(r["step"])
            ys.append(r[key])
    return xs, ys


def plot_training_run(
    records: List[Dict],
    out_dir: str,
    recent_steps: int = 200,
    include_loss: bool = True,
) -> List[str]:
    """Render the reference's training plot set from journal records.
    ``include_loss`` maps the ``plot_loss`` knob; ``recent_steps`` the
    ``recent_steps_loss`` knob (ref Plotting config section).
    Returns the written file paths."""
    plt = _pyplot()
    if plt is None:
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []

    # Loss plots: global + recent window (ref AlphaZero.py:963-1050).
    loss_scopes = (
        [("global", records), ("recent", records[-recent_steps:])]
        if include_loss
        else []
    )
    for scope, recs in loss_scopes:
        fig, ax = plt.subplots(figsize=(8, 5))
        for key, label in (
            ("loss/combined", "combined"),
            ("loss/policy", "policy"),
            ("loss/value", "value"),
        ):
            xs, ys = _series(recs, key)
            if xs:
                ax.plot(xs, ys, label=label, linewidth=1)
        ax.set_xlabel("training step")
        ax.set_ylabel("loss")
        ax.set_title(f"loss ({scope})")
        ax.legend()
        path = os.path.join(out_dir, f"loss_{scope}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)

    # Win-rate curves: policy/mcts x seats (ref AlphaZero.py:1052-1137).
    fig, ax = plt.subplots(figsize=(8, 5))
    any_wr = False
    for key in sorted(
        {k for r in records for k in r if k.startswith("wr/")}
    ):
        xs, ys = _series(records, key)
        if xs:
            ax.plot(xs, ys, marker="o", markersize=3, label=key[3:])
            any_wr = True
    # Non-loss curves (win+draw): the BASELINE milestone metric
    # (">=95% non-loss vs random").
    for key in sorted(
        {k for r in records for k in r if k.startswith("nonloss/")}
    ):
        xs, ys = _series(records, key)
        if xs:
            ax.plot(
                xs, ys, linestyle="--", linewidth=1,
                label=f"nonloss {key[8:]}",
            )
            any_wr = True
    if any_wr:
        ax.axhline(0.95, color="gray", linewidth=0.8, linestyle=":")
        ax.set_xlabel("training step")
        ax.set_ylabel("win / non-loss rate vs random")
        ax.set_ylim(0, 1.05)
        ax.legend(fontsize=7)
        path = os.path.join(out_dir, "win_rates.png")
        fig.savefig(path, dpi=100)
        written.append(path)
    plt.close(fig)

    # Value-head probes on the fixed state set
    # (ref update_state_set_data + plot, AlphaZero.py:1175-1179,1118-1137).
    probe_keys = sorted(
        {k for r in records for k in r if k.startswith("value_probe/")},
        key=lambda k: int(k.rsplit("/", 1)[1]),
    )
    if probe_keys:
        fig, ax = plt.subplots(figsize=(8, 5))
        for key in probe_keys:
            xs, ys = _series(records, key)
            if xs:
                ax.plot(xs, ys, label=f"state {key.rsplit('/', 1)[1]}")
        ax.set_xlabel("training step")
        ax.set_ylabel("value head output")
        ax.set_ylim(-1.05, 1.05)
        ax.set_title("value probes (fixed state set)")
        ax.legend()
        path = os.path.join(out_dir, "value_probes.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)

    # Weight-size series: |w| max/min/mean vs step (ref update_weight_data
    # + weight plots, AlphaZero.py:1164-1173,1181-1202), emitted by the
    # coordinator when ``plot_weights`` is on.
    weight_keys = [
        ("weights/abs_max", "max |w|"),
        ("weights/abs_mean", "mean |w|"),
        ("weights/abs_min", "min |w|"),
    ]
    if any(any(k in r for r in records) for k, _ in weight_keys):
        fig, ax = plt.subplots(figsize=(8, 5))
        for key, label in weight_keys:
            xs, ys = _series(records, key)
            if xs:
                ax.plot(xs, ys, label=label, linewidth=1)
        ax.set_xlabel("training step")
        ax.set_ylabel("|weight|")
        ax.set_yscale("log")
        ax.set_title("weight magnitude (all parameters)")
        ax.legend()
        path = os.path.join(out_dir, "weights.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)

    # Throughput.
    fig, ax = plt.subplots(figsize=(8, 4))
    xs, ys = _series(records, "step_time_s")
    if xs:
        ax.plot(xs, ys, linewidth=1)
        ax.set_xlabel("training step")
        ax.set_ylabel("step time (s)")
        path = os.path.join(out_dir, "step_time.png")
        fig.savefig(path, dpi=100)
        written.append(path)
    plt.close(fig)
    return written


def plot_iteration_sweep(
    results: Sequence[Tuple[int, Tuple[float, float, float]]],
    out_path: str,
    title: str = "win rate vs recurrent iterations",
    seat: int = 0,
    baselines: Optional[Dict[str, float]] = None,
    train_iterations: Optional[int] = None,
) -> List[str]:
    """Extrapolation curve (ref ``Plots/PlotMaker.py:11-148``): win rate as
    a function of test-time recurrent iterations, optional flat baselines
    (e.g. a ResNet's win rate) and a marker at the training iteration
    count.  Returns ``[out_path]``."""
    plt = _pyplot()
    if plt is None:
        return []
    xs = [v for v, _ in results]
    ys = [wr[seat] for _, wr in results]
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(xs, ys, marker="o", label="recurrent net")
    for name, y in (baselines or {}).items():
        ax.axhline(y, linestyle="--", alpha=0.6, label=name)
    if train_iterations is not None:
        ax.axvline(
            train_iterations, linestyle=":", alpha=0.6, label="train iters"
        )
    ax.set_xlabel("recurrent iterations at test time")
    ax.set_ylabel("win rate")
    ax.set_ylim(0, 1.05)
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return [out_path]


def plot_size_sweep(
    curves: Dict[str, Sequence[Tuple[int, Tuple[float, float, float]]]],
    out_path: str,
    title: str = "win rate vs board size",
    seat: int = 1,
    train_size: Optional[int] = None,
) -> List[str]:
    """Board-size-transfer curves (ref ``Plots/sizes/*.png`` +
    ``Plots/PlotMaker.py:20-35``): win rate as a function of board size,
    one line per test-time recurrent-iteration count, with a marker at the
    training size.  Returns ``[out_path]``."""
    plt = _pyplot()
    if plt is None:
        return []
    fig, ax = plt.subplots(figsize=(8, 5))
    for label, results in curves.items():
        xs = [v for v, _ in results]
        ys = [wr[seat] for _, wr in results]
        ax.plot(xs, ys, marker="o", label=label)
    if train_size is not None:
        ax.axvline(train_size, linestyle=":", alpha=0.6, label="train size")
    ax.set_xlabel("board size (NxN)")
    ax.set_ylabel("win rate")
    ax.set_ylim(0, 1.05)
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return [out_path]
