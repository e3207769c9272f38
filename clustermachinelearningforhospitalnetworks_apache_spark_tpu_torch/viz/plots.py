"""Diagnostic plots (the JAX package's ``viz/plots.py``).

Parity with the reference's matplotlib section (``mllearnforhospital
network.py:204-223``): a predicted-vs-actual scatter with the y=x line and
a residual scatter with the zero line, written as PNG files under an
output directory instead of ``plt.show()``.

matplotlib is the optional ``viz`` extra: it is imported when a plot is
drawn, and a missing one raises an ``ImportError`` that names the extra.
The ROC and PR curves need LogisticRegression's training summary, which
comes with slice 5 of the port.
"""

from __future__ import annotations

import os

import numpy as np


def figure_class():
    """matplotlib's ``Figure`` (figures are built directly, not through
    pyplot, so saving PNGs never touches the process-global backend);
    an ``ImportError`` naming the ``viz`` extra when it is missing."""
    try:
        from matplotlib.figure import Figure
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib: install the project's 'viz' extra "
            "(pip install '.[viz]'), or run without plots"
        ) from e
    return Figure


def _save(fig, out_dir: str, filename: str) -> str:
    """One copy of the output convention (makedirs + 120-dpi PNG)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def plot_predicted_vs_actual(
    actual: np.ndarray,
    predicted: np.ndarray,
    out_dir: str,
    label: str = "length_of_stay",
    filename: str = "predicted_vs_actual.png",
) -> str:
    fig = figure_class()(figsize=(8, 6))
    ax = fig.add_subplot(111)
    ax.scatter(actual, predicted, alpha=0.5, s=12)
    lo = float(min(np.min(actual), np.min(predicted)))
    hi = float(max(np.max(actual), np.max(predicted)))
    ax.plot([lo, hi], [lo, hi], "r--", linewidth=1.5)  # y = x (:212)
    ax.set_xlabel(f"actual {label}")
    ax.set_ylabel(f"predicted {label}")
    ax.set_title("Predicted vs Actual")
    return _save(fig, out_dir, filename)


def plot_residuals(
    actual: np.ndarray,
    predicted: np.ndarray,
    out_dir: str,
    filename: str = "residuals.png",
) -> str:
    residuals = np.asarray(actual) - np.asarray(predicted)
    fig = figure_class()(figsize=(8, 6))
    ax = fig.add_subplot(111)
    ax.scatter(predicted, residuals, alpha=0.5, s=12)
    ax.axhline(0.0, color="r", linestyle="--", linewidth=1.5)  # zero line (:221)
    ax.set_xlabel("predicted")
    ax.set_ylabel("residual (actual − predicted)")
    ax.set_title("Residuals")
    return _save(fig, out_dir, filename)
