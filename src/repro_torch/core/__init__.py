"""Core library of the port: OAVI (fast engine), IHB, ordering, Algorithm 2."""

from . import ihb, terms
from .oavi import Generator, OAVIConfig, OAVIModel, evaluate_terms, fit
from .ordering import pearson_order, pearson_scores
from .pipeline import PipelineConfig, VanishingIdealClassifier
from .svm import LinearSVM, LinearSVMConfig
from .transform import MinMaxScaler

__all__ = [
    "OAVIConfig", "OAVIModel", "Generator", "fit", "evaluate_terms",
    "pearson_order", "pearson_scores",
    "PipelineConfig", "VanishingIdealClassifier",
    "LinearSVM", "LinearSVMConfig", "MinMaxScaler", "ihb", "terms",
]
