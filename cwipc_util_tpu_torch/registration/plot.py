"""Analysis plots: distance-distribution histograms per camera.

Copied from cwipc_util_tpu/registration/plot.py.  matplotlib is imported
when a plot is drawn, never on import; where it is not installed, drawing
raises :class:`CwipcError` naming it.  The plots read only the analyzers'
host-side histograms.

Re-implementation of the reference's plot module
(reference: python/cwipc/registration/plot.py:18-116): per-camera histogram
+ cumulative curves of the nearest-distance distributions, with the chosen
correspondence marked.  Uses the Agg backend so it works headless; shows
interactively when a display is available.
"""

from __future__ import annotations

from typing import Container, Iterable, List, Optional, Union

import numpy as np

from ..core.errors import CwipcError
from .abstract import AnalysisResults

# 12 plot colors; the first 4 match the per-camera tile colors
# (reference: plot.py:6).
PLOT_COLORS = [
    "r", "g", "b", "orange", "magenta", "cyan", "yellow", "lime",
    "violet", "chocolate", "slategrey", "lavender",
]

DEFAULT_PLOT_STYLE = ["count", "cumulative"]


def set_default_plot_style(style: Union[str, Iterable[str]]) -> None:
    """Set the styles Plotter.plot() uses when none are passed
    (reference: plot.py:10-15); a string is comma-split."""
    global DEFAULT_PLOT_STYLE
    if isinstance(style, str):
        DEFAULT_PLOT_STYLE = style.split(",")
    else:
        DEFAULT_PLOT_STYLE = list(style)


def _get_plt():
    import os

    try:
        import matplotlib
    except ImportError as e:
        raise CwipcError("plotting the registration analysis needs matplotlib, which is not installed") from e
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Plotter:
    """Stateful plot maker over a set of AnalysisResults
    (reference: plot.py:18-116): per-camera distance histograms with
    optional cumulative twin axis, correspondence markers and binned
    delta curves, styles chosen by a container of names
    ("count"/"cumulative"/"delta"/"log"/"all")."""

    def __init__(self, title: str):
        self.title = title
        self.results: List[AnalysisResults] = []

    def set_results(self, results: List[AnalysisResults]) -> None:
        self.results = results

    def plot(
        self,
        filename: Optional[str] = None,
        show: bool = False,
        which: Optional[Container[str]] = None,
    ) -> None:
        assert self.results
        if not filename and not show:
            return
        if which is None:
            which = DEFAULT_PLOT_STYLE
        do_count = "count" in which or "all" in which
        do_cumulative = "cumulative" in which or "all" in which
        do_delta = "delta" in which or "all" in which
        do_log = "log" in which
        plt = _get_plt()
        fig, ax = plt.subplots()
        if do_log:
            ax.set_yscale("symlog")
        ax.set_xlabel("Distance (m)")
        ax.set_ylabel("log(count)" if do_log else "count")
        ax_cum = ax.twinx() if do_cumulative else None
        if ax_cum is not None:
            ax_cum.set_ylabel("cumulative")
        corr_for_label = {}
        algorithm = variant = None
        for cam_i, res in enumerate(self.results):
            if res.histogram is None or res.histogramEdges is None:
                continue
            color = PLOT_COLORS[cam_i % len(PLOT_COLORS)]
            label = f"{res.tilemask}"
            if res.referenceTilemask:
                label += f" vs {res.referenceTilemask}"
            corr_for_label[label] = res.tostr()
            algorithm, variant = res.algorithm, res.variant
            corr = res.minCorrespondence
            if do_count or not (do_cumulative or do_delta):
                ax.plot(res.histogramEdges[1:], res.histogram, label=label, color=color)
            if ax_cum is not None:
                cumsum = np.cumsum(res.histogram)
                total = cumsum[-1] or 1
                ax_cum.plot(res.histogramEdges[1:], cumsum / total,
                            linestyle="dashed", label="_nolegend_", color=color)
                ax_cum.plot([corr, corr], [0, 1], linestyle="dotted",
                            label="_nolegend_", color=color)
            if do_delta:
                # deltas over bins about half the correspondence wide
                # (reference: plot.py:88-99)
                corr_bin = max(2, int(np.digitize(corr, res.histogramEdges)))
                nbin = max(1, len(res.histogram) // (corr_bin // 2))
                while len(res.histogram) % nbin != 0:
                    nbin += 1
                new_edges = res.histogramEdges[0::nbin]
                new_histo = np.reshape(res.histogram, (-1, nbin)).sum(axis=1) / nbin
                delta = np.diff(new_histo)
                ax.plot([new_edges[0], new_edges[-1]], [0, 0], linestyle="solid",
                        label="_nolegend_", color="black", linewidth=0.2)
                ax.plot(new_edges[1:-1], delta, marker=".", linewidth=0,
                        label="_nolegend_", color=color)
        title = self.title
        if algorithm:
            title = f"{title}\n{algorithm}"
        if variant:
            title = f"{title} ({variant})"
        ax.set_title(title)
        handles, labels = ax.get_legend_handles_labels()
        labels = [x + ": " + corr_for_label.get(x, "") for x in labels]
        fig.subplots_adjust(bottom=0.2)
        fig.legend(handles, labels, loc="lower center", bbox_to_anchor=(0.5, 0.0))
        if filename:
            fig.savefig(filename)
        if show:
            import matplotlib

            if matplotlib.get_backend().lower() == "agg":
                if not filename:
                    fig.savefig("registration_analysis.png")
                    print("plot: saved registration_analysis.png (no display)")
            else:
                plt.show()
        plt.close(fig)


def plot_analysis_results(
    results: List[AnalysisResults],
    filename: Optional[str] = None,
    title: str = "Registration analysis",
    cumulative: bool = True,
) -> None:
    """Histogram (and cumulative) of distances per camera, correspondence
    marked with a vertical line.  Saves to `filename` or shows the window."""
    plt = _get_plt()
    nplots = 2 if cumulative else 1
    fig, axes = plt.subplots(nplots, 1, figsize=(10, 4 * nplots), squeeze=False)
    ax = axes[0][0]
    for res in results:
        if res.histogram is None or res.histogramEdges is None:
            continue
        centers = (res.histogramEdges[:-1] + res.histogramEdges[1:]) / 2
        label = f"tile {res.tilemask}" if res.tilemask is not None else res.algorithm
        (line,) = ax.plot(centers, res.histogram, label=label)
        ax.axvline(res.minCorrespondence, color=line.get_color(), linestyle="--", alpha=0.6)
    ax.set_xlabel("distance (m)")
    ax.set_ylabel("point count")
    ax.set_title(title)
    ax.legend()
    if cumulative:
        ax2 = axes[1][0]
        for res in results:
            if res.histogram is None or res.histogramEdges is None:
                continue
            centers = (res.histogramEdges[:-1] + res.histogramEdges[1:]) / 2
            total = res.histogram.sum() or 1
            label = f"tile {res.tilemask}" if res.tilemask is not None else res.algorithm
            ax2.plot(centers, np.cumsum(res.histogram) / total, label=label)
        ax2.set_xlabel("distance (m)")
        ax2.set_ylabel("cumulative fraction")
        ax2.legend()
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
    else:
        import matplotlib

        if matplotlib.get_backend().lower() == "agg":
            fig.savefig("registration_analysis.png")
            print("plot: saved registration_analysis.png (no display)")
        else:
            plt.show()
    plt.close(fig)
