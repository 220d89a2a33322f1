"""Randomized truncated SVD for padded-sparse corpora.

Computes the rank-``k`` LSA factorisation of the implicit tf-idf matrix
``A (docs x vocab)`` given in padded (terms, weights) form, without ever
densifying ``A``:

* ``A @ Y``  -> embedding-bag: gather ``Y[terms]``, weight, sum over the
  pad axis -- ``O(nnz * r)``;
* ``A.T @ X`` -> scatter: a fixed-order segment sum of ``w * X[doc]`` over
  term ids.

Both walk the doc axis a block of rows at a time, so the gathered
(rows, T, r) tensor stays near ``_BLOCK_ELEMENTS`` elements (the whole one
is 42 GB at 262,144 docs x 96 terms x 416 columns).  A row's sum over T is
one reduction over the block's middle axis.  ``A.T @ X`` sums in a fixed
order, so its bits do not change from run to run on the card: a term gets
many contributions within a block, so the block's term ids are
stable-sorted and ``segment_reduce`` sums each term's run in block order;
the block sums, one per distinct term, go into the output by
``index_add_`` with no index twice, the blocks in order.

Halko-Martinsson-Tropp randomized range finder with power iterations and
QR re-orthogonalisation.  The Gaussian test matrix comes from an explicit
``torch.Generator``; :func:`randomized_svd_from_omega` takes it as an
argument, so a test can feed both packages the same one.  QR and SVD fix
column signs differently from the JAX package, so compare sign-free
quantities: singular values, the doc-doc cosines, nearest neighbours.
Products run in plain float32 (TF32 off on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.rerank import check_fp32_matmul, normalize

__all__ = ["LsaModel", "randomized_svd", "randomized_svd_from_omega",
           "matvec_bags", "rmatvec_bags", "fold_in"]

_BLOCK_ELEMENTS = 1 << 25


class LsaModel(NamedTuple):
    v: torch.Tensor         # (vocab, k) right singular vectors
    s: torch.Tensor         # (k,) singular values
    doc_vecs: torch.Tensor  # (d, k) = U*S, unit-normalised rows


def _rows(T: int, r: int, block: Optional[int]) -> int:
    return block or max(1, _BLOCK_ELEMENTS // max(1, T * r))


def matvec_bags(terms: torch.Tensor, weights: torch.Tensor, Y: torch.Tensor,
                block: Optional[int] = None) -> torch.Tensor:
    """A @ Y for padded bags: (d, T) x (vocab, r) -> (d, r), ``block``
    docs at a time (default: near ``_BLOCK_ELEMENTS`` gathered)."""
    d, T = terms.shape
    r = Y.shape[1]
    out = torch.empty((d, r), dtype=torch.float32, device=Y.device)
    step = _rows(T, r, block)
    for lo in range(0, d, step):
        t = terms[lo:lo + step]
        w = torch.where(t >= 0, weights[lo:lo + step], 0.0)
        g = Y[torch.clamp(t, min=0).long()]                 # (rows, T, r)
        out[lo:lo + step] = (w[..., None] * g).sum(dim=1)
    return out


def rmatvec_bags(terms: torch.Tensor, weights: torch.Tensor, X: torch.Tensor,
                 vocab_size: int, block: Optional[int] = None
                 ) -> torch.Tensor:
    """A.T @ X: (d, T) x (d, r) -> (vocab, r) by fixed-order segment sums,
    ``block`` docs at a time (see the module doc); pads go to a dropped
    extra row."""
    d, T = terms.shape
    r = X.shape[1]
    out = torch.zeros((vocab_size + 1, r), dtype=torch.float32,
                      device=X.device)
    step = _rows(T, r, block)
    for lo in range(0, d, step):
        t = terms[lo:lo + step]
        tid = torch.where(t >= 0, t, vocab_size).reshape(-1)
        tid, order = torch.sort(tid, stable=True)
        uniq, counts = torch.unique_consecutive(tid, return_counts=True)
        contrib = weights[lo:lo + step, :, None] * X[lo:lo + step, None, :]
        seg = torch.segment_reduce(contrib.reshape(-1, r)[order], "sum",
                                   lengths=counts)
        out.index_add_(0, uniq.long(), seg)
    return out[:vocab_size]


def randomized_svd(
    terms: torch.Tensor,
    weights: torch.Tensor,
    vocab_size: int,
    k: int = 400,
    oversample: int = 16,
    n_iter: int = 3,
    seed: int = 0,
    block: Optional[int] = None,
) -> LsaModel:
    """Rank-``k`` LSA of the padded tf-idf corpus, on ``weights``' device;
    the (vocab, k + oversample) Gaussian test matrix is drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=weights.device).manual_seed(seed)
    omega = torch.randn((vocab_size, k + oversample), generator=gen,
                        dtype=torch.float32, device=weights.device)
    return randomized_svd_from_omega(terms, weights, omega, k, n_iter, block)


def randomized_svd_from_omega(
    terms: torch.Tensor,
    weights: torch.Tensor,
    omega: torch.Tensor,       # (vocab, r) Gaussian test matrix
    k: int = 400,
    n_iter: int = 3,
    block: Optional[int] = None,
) -> LsaModel:
    """The range finder and the small SVD on a given test matrix."""
    check_fp32_matmul(weights)
    vocab_size = omega.shape[0]
    Y, _ = torch.linalg.qr(matvec_bags(terms, weights, omega, block))
    for _ in range(n_iter):
        Z, _ = torch.linalg.qr(rmatvec_bags(terms, weights, Y, vocab_size,
                                            block))
        Y, _ = torch.linalg.qr(matvec_bags(terms, weights, Z, block))
    B = rmatvec_bags(terms, weights, Y, vocab_size, block).T       # (r, v)
    Ub, S, Vt = torch.linalg.svd(B, full_matrices=False)
    s = S[:k]
    doc = normalize((Y @ Ub[:, :k]) * s[None, :])
    return LsaModel(v=Vt[:k].T.contiguous(), s=s, doc_vecs=doc)


def fold_in(model: LsaModel, terms: torch.Tensor, weights: torch.Tensor,
            block: Optional[int] = None) -> torch.Tensor:
    """Project new tf-idf bags into the LSA space: q = A_q @ V, unit rows."""
    check_fp32_matmul(weights)
    return normalize(matvec_bags(terms, weights, model.v, block))
