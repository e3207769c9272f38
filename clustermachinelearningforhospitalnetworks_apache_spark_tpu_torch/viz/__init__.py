from .plots import plot_predicted_vs_actual, plot_residuals

__all__ = ["plot_predicted_vs_actual", "plot_residuals"]
