"""End-to-end LSA pipeline: corpus -> tf-idf -> randomized SVD -> unit vectors.

This is the paper's §3 setup ("LSA with 400 features over TF-IDF ... all
vectors normalized to unit length") as one call, on one device
(``"cuda"`` unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.data.synthetic import TopicCorpus

from .svd import LsaModel, fold_in, randomized_svd
from .tfidf import TfIdf, fit_tfidf, transform

__all__ = ["LsaPipeline", "build_lsa"]


class LsaPipeline(NamedTuple):
    tfidf: TfIdf
    lsa: LsaModel

    @property
    def doc_vectors(self) -> torch.Tensor:
        return self.lsa.doc_vecs

    def embed(self, doc_terms, doc_tf) -> torch.Tensor:
        """Fold new documents into the latent space (unit rows), on the
        model's device; numpy or tensors."""
        dev = self.lsa.v.device
        terms = torch.as_tensor(doc_terms, device=dev)
        w = transform(self.tfidf, terms, torch.as_tensor(doc_tf, device=dev))
        return fold_in(self.lsa, terms, w)


def build_lsa(
    corpus: TopicCorpus,
    n_features: int = 400,
    oversample: int = 16,
    n_iter: int = 3,
    seed: int = 0,
    device="cuda",
) -> LsaPipeline:
    terms = torch.as_tensor(corpus.doc_terms, device=device)
    tfidf = fit_tfidf(terms, corpus.vocab_size)
    w = transform(tfidf, terms, torch.as_tensor(corpus.doc_tf, device=device))
    lsa = randomized_svd(terms, w, vocab_size=corpus.vocab_size,
                         k=n_features, oversample=oversample, n_iter=n_iter,
                         seed=seed)
    return LsaPipeline(tfidf=tfidf, lsa=lsa)
