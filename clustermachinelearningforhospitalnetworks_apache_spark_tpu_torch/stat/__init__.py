"""``pyspark.ml.stat`` on the device (the JAX package's ``stat/``)."""

from .stat import (
    ANOVATest,
    ChiSquareTest,
    ChiSquareTestResult,
    Correlation,
    FTestResult,
    FValueTest,
    KolmogorovSmirnovTest,
    KolmogorovSmirnovTestResult,
    Summarizer,
    SummaryStats,
)

__all__ = [
    "ANOVATest", "ChiSquareTest", "ChiSquareTestResult", "Correlation", "FTestResult",
    "FValueTest", "KolmogorovSmirnovTest", "KolmogorovSmirnovTestResult", "Summarizer",
    "SummaryStats",
]
