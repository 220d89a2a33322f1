"""TF-IDF weighting over padded bag-of-words corpora (paper §2.3, §3)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TfIdf", "fit_tfidf", "transform"]


class TfIdf(NamedTuple):
    idf: torch.Tensor  # (vocab,) f32
    vocab_size: int


def fit_tfidf(doc_terms: torch.Tensor, vocab_size: int) -> TfIdf:
    """doc_terms: (d, T) int padded with -1 -> idf ``log1p(d / (1 + df))``.
    Document frequencies are counted by ``index_add_`` (integers below
    2^24, exact in any order)."""
    d = doc_terms.shape[0]
    valid = doc_terms >= 0
    tid = torch.where(valid, doc_terms, vocab_size).reshape(-1).long()
    df = torch.zeros(vocab_size + 1, dtype=torch.float32,
                     device=doc_terms.device)
    df.index_add_(0, tid, valid.reshape(-1).to(torch.float32))
    # a float32 tensor numerator: ``d / t`` would multiply by 1 / t
    n = torch.tensor(float(d), dtype=torch.float32, device=doc_terms.device)
    return TfIdf(idf=torch.log1p(n / (1.0 + df[:vocab_size])),
                 vocab_size=vocab_size)


def transform(model: TfIdf, doc_terms: torch.Tensor,
              doc_tf: torch.Tensor) -> torch.Tensor:
    """-> (d, T) l2-normalised tf-idf weights aligned with doc_terms."""
    valid = doc_terms >= 0
    tid = torch.clamp(doc_terms, min=0).long()
    w = (1.0 + torch.log(torch.clamp(doc_tf.to(torch.float32), min=1.0))
         ) * model.idf[tid]
    w = torch.where(valid, w, 0.0)
    norm = torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True),
                       min=1e-12)
    return w / norm
