"""Figures of a finished run (``--plot``).

Counterpart of ``demethify_tpu/plotting.py``: the same files under
``<outdir>/plots/``, the same palette and the same figures, drawn from
numpy arrays and names instead of pandas frames.

* ``proportions_stackedbar.png``: one stacked bar per sample;
* ``proportions_bar_<sample>.png``: per-sample bars, with bootstrap
  confidence whiskers when intervals are given (the stem is the sample
  label without its last four characters, as the reference names them);
* ``ic_plot.png``: the criterion against the number of unknowns (``--ic``
  runs only).

The CLI's intervals are matched to the proportions' rows by cell-type
name (``intervals_by_name``): after an ``--ic`` run the bootstrap covers
the known cell types only, and the unknowns get no whisker. (The JAX CLI
raises ValueError there, on the rows' count.)

matplotlib is imported inside the functions (a GPU host may have none;
the CLI checks for it before it reads any data, ``require``).
The palette takes colorcet's glasbey table when colorcet is installed,
else a golden-angle hue walk.
"""

import colorsys
import os
from typing import Optional, Sequence

import numpy as np

_DPI = 300
# successive hues land maximally far apart
_GOLDEN = 0.6180339887498949


def require() -> None:
    """Exit with an error naming the package when matplotlib is missing:
    the CLI calls this before it reads any data when ``--plot`` is
    given."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit("Error: --plot needs the matplotlib package, which "
                         "is not installed; install it or drop --plot.")


def intervals_by_name(lower, upper, names, cell_types):
    """(lower, upper) of the intervals of ``names`` (rows of lower and
    upper) laid out on the rows ``cell_types``; NaN (no whisker) for a
    cell type without an interval."""
    row = {name: k for k, name in enumerate(names)}
    lower, upper = np.asarray(lower), np.asarray(upper)
    nan = np.full(lower.shape[1], np.nan)
    return tuple(np.array([x[row[c]] if c in row else nan
                           for c in cell_types]) for x in (lower, upper))


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def categorical_palette(n: int) -> list:
    """``n`` visually distinct RGB triples: colorcet's glasbey table when
    colorcet is installed, else a golden-angle hue walk over a small grid
    of (saturation, value) pairs."""
    try:
        import colorcet as cc
        import matplotlib.colors

        table = list(cc.glasbey)
        if n <= len(table):
            return [matplotlib.colors.to_rgb(c) for c in table[:n]]
    except ImportError:
        pass

    sat_val = [(0.85, 0.85), (0.55, 0.95), (0.95, 0.60), (0.40, 0.75)]
    colors = []
    h = 0.12   # away from pure red, so the whiskers stay readable
    for i in range(n):
        s, v = sat_val[i % len(sat_val)]
        colors.append(colorsys.hsv_to_rgb(h % 1.0, s, v))
        h += _GOLDEN
    return colors


def save_stacked_bar(props: np.ndarray, cell_types: Sequence[str],
                     samples: Sequence[str], path: str, colors) -> None:
    """All samples side by side, each a stacked bar of proportions
    (``props`` (n_cell_types, n_samples))."""
    plt = _pyplot()
    n_samples = props.shape[1]
    fig, ax = plt.subplots(figsize=(max(8.0, 0.9 * n_samples + 4.0), 6.0))
    x = np.arange(n_samples)
    bottom = np.zeros(n_samples)
    values = np.asarray(props, dtype=float)
    for row, (ct, color) in enumerate(zip(cell_types, colors)):
        ax.bar(x, values[row], bottom=bottom, width=0.72, label=str(ct),
               color=color, edgecolor="white", linewidth=0.4)
        bottom += values[row]
    ax.set_xticks(x)
    ax.set_xticklabels([str(c) for c in samples], rotation=45, ha="right")
    ax.set_ylim(0.0, max(1.0, float(bottom.max())) * 1.02)
    ax.set_ylabel("Estimated proportion")
    ax.set_title("Cell-type composition per sample")
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(title="Cell type", frameon=False, bbox_to_anchor=(1.02, 1.0),
              loc="upper left", fontsize=8)
    fig.savefig(path, dpi=_DPI, bbox_inches="tight")
    plt.close(fig)


def save_sample_bars(props: np.ndarray, cell_types: Sequence[str],
                     samples: Sequence[str], outdir_plots: str, colors,
                     ci: Optional[tuple] = None) -> None:
    """One figure per sample; whiskers from ``ci`` = (lower, upper), each
    (n_cell_types, n_samples), when given."""
    plt = _pyplot()
    labels = [str(ct) for ct in cell_types]
    x = np.arange(len(labels))
    for j, sample in enumerate(samples):
        point = np.asarray(props[:, j], dtype=float)
        fig, ax = plt.subplots(figsize=(max(6.0, 0.45 * len(labels) + 3.0),
                                        5.0))
        ax.bar(x, point, width=0.7, color=colors, edgecolor="white",
               linewidth=0.4)
        if ci is not None:
            lo = np.asarray(ci[0][:, j], dtype=float)
            hi = np.asarray(ci[1][:, j], dtype=float)
            ax.errorbar(x, point, yerr=np.vstack([np.abs(point - lo),
                                                  np.abs(hi - point)]),
                        fmt="none", ecolor="0.15", elinewidth=1.2,
                        capsize=4)
        ax.set_xticks(x)
        ax.set_xticklabels(labels, rotation=90, fontsize=8)
        ax.set_ylabel("Estimated proportion")
        ax.set_title(f"Composition of {sample}")
        ax.spines[["top", "right"]].set_visible(False)
        ax.margins(x=0.01)
        fig.savefig(os.path.join(
            outdir_plots, f"proportions_bar_{str(sample)[:-4]}.png"),
            dpi=_DPI, bbox_inches="tight")
        plt.close(fig)


def save_ic_curve(list_ic: Sequence[float], path: str) -> None:
    """Criterion value against the number of unknowns, with the argmin
    called out."""
    plt = _pyplot()
    values = np.asarray(list_ic, dtype=float)
    ranks = np.arange(1, values.size + 1)
    best = int(np.argmin(values))
    fig, ax = plt.subplots(figsize=(7.0, 4.5))
    ax.plot(ranks, values, color="#2a6f97", linewidth=1.8, zorder=2)
    ax.scatter(ranks, values, s=24, color="#2a6f97", zorder=3)
    ax.scatter([ranks[best]], [values[best]], s=90, facecolor="none",
               edgecolor="#c1121f", linewidth=2.0, zorder=4)
    ax.annotate(f"best: {ranks[best]} unknown(s)",
                xy=(ranks[best], values[best]),
                xytext=(8, 12), textcoords="offset points",
                color="#c1121f", fontsize=10)
    ax.set_xlabel("Number of unknown components")
    ax.set_ylabel("Criterion value")
    ax.set_title("Model selection")
    if values.size <= 30:
        ax.set_xticks(ranks)
    ax.grid(True, axis="y", alpha=0.25)
    ax.spines[["top", "right"]].set_visible(False)
    fig.savefig(path, dpi=_DPI, bbox_inches="tight")
    plt.close(fig)


def plot_proportions(props: np.ndarray, cell_types: Sequence[str],
                     samples: Sequence[str], outdir: str,
                     ci: Optional[tuple] = None,
                     list_ic: Optional[Sequence[float]] = None) -> None:
    """Every figure family of a finished run: ``props`` (n_cell_types,
    n_samples) with its row and column names, ``ci`` = (lower, upper) of
    the same shape or None, ``list_ic`` the criterion of ranks 1..len or
    None."""
    outdir_plots = os.path.join(outdir, "plots")
    os.makedirs(outdir_plots, exist_ok=True)
    colors = categorical_palette(len(cell_types))
    save_stacked_bar(props, cell_types, samples,
                     os.path.join(outdir_plots, "proportions_stackedbar.png"),
                     colors)
    save_sample_bars(props, cell_types, samples, outdir_plots, colors, ci)
    if list_ic is not None and len(list_ic):
        save_ic_curve(list_ic, os.path.join(outdir_plots, "ic_plot.png"))
    print("Plots generated in " + outdir_plots)
