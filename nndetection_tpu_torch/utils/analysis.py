"""Result plots on the host (copy of ``plot_froc_curves`` of
:mod:`nndetection_tpu.utils.analysis`); matplotlib is optional."""
from __future__ import annotations

from pathlib import Path
from typing import Dict


def plot_froc_curves(curves: Dict, save_path) -> None:
    """Plot FROC curves from the evaluator's curve dict
    (``FROC_curve_IoU_*`` + ``FROC_fpi_thresholds``); does nothing without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return
    fpi = curves.get("FROC_fpi_thresholds")
    if fpi is None:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    for k, v in curves.items():
        if k.startswith("FROC_curve_IoU_"):
            ax.plot(fpi, v, marker="o", label=k.replace("FROC_curve_", ""))
    ax.set_xscale("log", base=2)
    ax.set_xlabel("false positives per image")
    ax.set_ylabel("sensitivity")
    ax.set_ylim(0, 1.02)
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
