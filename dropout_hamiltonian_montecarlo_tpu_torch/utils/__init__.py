"""Profiling, conversion, preprocessing and gradient-check helpers."""

from .gradcheck import check_gradient
from .preprocessing import MinMaxScaler, flatten, one_hot

__all__ = ["one_hot", "MinMaxScaler", "flatten", "check_gradient"]
