"""Latent semantic analysis: tf-idf, randomized SVD, fold-in, pipeline."""

from .pipeline import LsaPipeline, build_lsa
from .svd import LsaModel, fold_in, randomized_svd
from .tfidf import TfIdf, fit_tfidf, transform

__all__ = ["LsaPipeline", "build_lsa", "LsaModel", "fold_in", "randomized_svd",
           "TfIdf", "fit_tfidf", "transform"]
