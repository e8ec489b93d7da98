from .metrics import (mean_absolute_error, mean_squared_error, mean_standardized_log_loss,
                      negative_log_predictive_density, quantile_coverage_error, standardized_mean_squared_error)

__all__ = ["mean_absolute_error", "mean_squared_error", "mean_standardized_log_loss", "negative_log_predictive_density",
           "quantile_coverage_error", "standardized_mean_squared_error"]
