"""Models."""

from .base import Model
from .softmax import Softmax

__all__ = ["Model", "Softmax"]
