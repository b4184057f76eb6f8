"""Core library of the port: OAVI, ABM, VCA, IHB, ordering, Algorithm 2."""

from . import abm, ihb, terms, vca
from .oavi import Generator, OAVIConfig, OAVIModel, evaluate_terms, fit
from .ordering import pearson_order, pearson_scores
from .pipeline import PipelineConfig, VanishingIdealClassifier
from .svm import LinearSVM, LinearSVMConfig, PolySVM, PolySVMConfig
from .transform import MinMaxScaler, feature_transform

__all__ = [
    "OAVIConfig", "OAVIModel", "Generator", "fit", "evaluate_terms",
    "pearson_order", "pearson_scores",
    "PipelineConfig", "VanishingIdealClassifier",
    "LinearSVM", "LinearSVMConfig", "PolySVM", "PolySVMConfig", "MinMaxScaler",
    "feature_transform",
    "abm", "ihb", "terms", "vca",
]
