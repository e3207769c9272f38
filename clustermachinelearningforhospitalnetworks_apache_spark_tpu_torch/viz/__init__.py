from .plots import plot_pr, plot_predicted_vs_actual, plot_residuals, plot_roc

__all__ = ["plot_pr", "plot_predicted_vs_actual", "plot_residuals", "plot_roc"]
