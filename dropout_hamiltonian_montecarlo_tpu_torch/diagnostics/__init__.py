"""Convergence and calibration diagnostics."""

from .calibration import (
    calibration_report,
    expected_calibration_error,
    posterior_predictive_probs,
    predictive_nll,
    reliability_bins,
)
from .ess import effective_sample_size, ess_pytree
from .rhat import potential_scale_reduction, split_rhat, split_rhat_pytree
from .summary import draw_diagnostics, summarize

__all__ = [
    "effective_sample_size",
    "ess_pytree",
    "draw_diagnostics",
    "potential_scale_reduction",
    "split_rhat",
    "split_rhat_pytree",
    "summarize",
    "calibration_report",
    "expected_calibration_error",
    "posterior_predictive_probs",
    "predictive_nll",
    "reliability_bins",
]
