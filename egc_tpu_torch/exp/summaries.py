"""Final-run summaries (a copy of ``egc_tpu.exp.summaries``, numpy only):
the exptune ``TrialCurvePlotter`` / ``TestMetricSummaries`` surface
(reference call sites ``experiments/zinc/configs.py:182-186``). The curves
go to CSV, and to a PNG only where ``matplotlib`` imports."""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


class TrialCurvePlotter:
    """Writes per-iteration metric curves across repeats to CSV (and a PNG
    when matplotlib is available)."""

    def __init__(self, metric_names: Sequence[str], name: str = "curves"):
        self.metric_names = list(metric_names)
        self.name = name

    def __call__(self, histories: List[List[Dict]], out_dir: Path):
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        csv_path = out_dir / f"{self.name}.csv"
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["repeat", "iteration"] + self.metric_names)
            for rep, hist in enumerate(histories):
                for row in hist:
                    writer.writerow(
                        [rep, row.get("iteration")] +
                        [row.get(m) for m in self.metric_names])
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(7, 4))
            for m in self.metric_names:
                for rep, hist in enumerate(histories):
                    xs = [r["iteration"] for r in hist if m in r]
                    ys = [r[m] for r in hist if m in r]
                    ax.plot(xs, ys, alpha=0.6,
                            label=m if rep == 0 else None)
            ax.set_xlabel("iteration")
            ax.legend()
            fig.tight_layout()
            fig.savefig(out_dir / f"{self.name}.png", dpi=100)
            plt.close(fig)
        except Exception:  # matplotlib optional
            pass
        return csv_path


class TestMetricSummaries:
    """mean/std/min/max over repeats for every test metric."""

    def __call__(self, test_metrics: List[Dict[str, float]], out_dir: Path
                 ) -> Dict[str, Dict[str, float]]:
        out = {}
        for key in test_metrics[0]:
            vals = np.array([t[key] for t in test_metrics], np.float64)
            out[key] = {
                "mean": float(vals.mean()),
                "std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
                "min": float(vals.min()),
                "max": float(vals.max()),
            }
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / "test_metric_summaries.json").write_text(
            json.dumps(out, indent=2))
        return out
