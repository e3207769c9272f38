"""Operational insights report.

Parity with the reference's final report section (``mllearnforhospital
network.py:245-255``): restates the model metrics, the feature importances
(:228-235) and the staffing recommendation, as a formatted string (the
reference prints; we return the text and optionally print, so callers can
log/persist it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence


@dataclass
class InsightsReport:
    app_name: str
    regression_rmse: Mapping[str, float] = field(default_factory=dict)
    classification_accuracy: Mapping[str, float] = field(default_factory=dict)
    feature_importances: Mapping[str, Mapping[str, float]] = field(default_factory=dict)
    feature_cols: Sequence[str] = ()
    los_threshold: float = 5.0
    extra_lines: Sequence[str] = ()

    def render(self) -> str:
        lines = [
            "=" * 64,
            f"OPERATIONAL INSIGHTS — {self.app_name}",
            "=" * 64,
            "",
            "Regression (predicting length_of_stay, RMSE — lower is better):",
        ]
        for name, rmse in self.regression_rmse.items():
            lines.append(f"  {name:<28s} RMSE = {rmse:.4f}")
        lines.append("")
        lines.append(
            f"Classification (high-risk = LOS > {self.los_threshold:g}, accuracy):"
        )
        for name, acc in self.classification_accuracy.items():
            lines.append(f"  {name:<28s} accuracy = {acc:.4f}")
        if self.feature_importances:
            lines.append("")
            lines.append("Feature importances:")
            for model, imps in self.feature_importances.items():
                lines.append(f"  {model}:")
                for feat, v in imps.items():
                    lines.append(f"    {feat:<24s} {v:.4f}")
        lines += [
            "",
            "Recommendation: hospitals with predicted length-of-stay above "
            f"{self.los_threshold:g} days should be prioritized for staffing "
            "and bed-capacity planning in the next scheduling window.",
        ]
        lines.extend(self.extra_lines)
        lines.append("=" * 64)
        return "\n".join(lines)

    def print(self) -> None:  # the reference's behavior (:245-255)
        print(self.render())
