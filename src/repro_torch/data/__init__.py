"""Datasets of the paper's experiments (copies of the JAX package's)."""

from . import synthetic
from .synthetic import appendix_c, random_cube, train_test_split, uci_like

__all__ = ["synthetic", "appendix_c", "random_cube", "train_test_split", "uci_like"]
