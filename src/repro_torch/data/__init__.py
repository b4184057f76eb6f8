"""Datasets of the paper's experiments (copies of the JAX package's) and the
deterministic LM token pipeline (:mod:`~repro_torch.data.lm`)."""

from . import lm, synthetic
from .synthetic import appendix_c, random_cube, train_test_split, uci_like

__all__ = ["lm", "synthetic", "appendix_c", "random_cube", "train_test_split", "uci_like"]
