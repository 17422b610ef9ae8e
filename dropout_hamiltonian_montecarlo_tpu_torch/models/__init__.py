"""Models."""

from .base import Model
from .gaussian import Gaussian
from .logistic import Logistic
from .mlp import DropoutMasks, DropoutMLP
from .mvn_gaussian import MVNGaussian
from .poisson import Poisson
from .softmax import Softmax

__all__ = ["Model", "Gaussian", "MVNGaussian", "Logistic", "Softmax", "Poisson",
           "DropoutMLP", "DropoutMasks"]
