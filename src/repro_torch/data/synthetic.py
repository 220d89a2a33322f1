"""Deterministic synthetic corpora with topic structure.

The paper evaluates on 4.18M Wikipedia articles.  This module stands in a
topic-mixture corpus: every document draws a sparse Dirichlet mixture
over ``n_topics`` latent topics, each topic being a Zipf-ish distribution
over its own vocabulary slice (plus a shared background slice).  That is
the structure LSA exploits -- documents about the same topics become near
neighbours in the latent space -- so the quality curves (P@10 / nDCG /
avg.diff against page, trim, best) behave like the paper's.

A numpy copy of the JAX package's generator: the same arguments and seed
give the byte-identical corpus, drawn on the host.  ``lm_batch`` is its
LM token-stream generator, copied the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TopicCorpus", "make_corpus", "lm_batch"]


@dataclasses.dataclass(frozen=True)
class TopicCorpus:
    doc_terms: np.ndarray   # (d, T) int32 padded with -1
    doc_tf: np.ndarray      # (d, T) f32 counts (0 where pad)
    vocab_size: int
    n_topics: int
    doc_topics: np.ndarray  # (d, n_topics) f32 -- the true mixtures (for tests)


def make_corpus(
    n_docs: int = 5000,
    vocab_size: int = 20000,
    n_topics: int = 50,
    doc_len: int = 120,
    max_unique: int = 96,
    alpha: float = 0.08,
    background_frac: float = 0.15,
    seed: int = 0,
) -> TopicCorpus:
    """Topic-mixture bag-of-words corpus, padded to ``max_unique`` terms/doc."""
    rng = np.random.default_rng(seed)
    n_bg = int(vocab_size * background_frac)
    topic_vocab = vocab_size - n_bg
    per_topic = topic_vocab // n_topics

    # Zipf weights within each topic's slice and the background slice
    zipf = 1.0 / np.arange(1, per_topic + 1) ** 1.1
    zipf /= zipf.sum()
    bg_zipf = 1.0 / np.arange(1, n_bg + 1) ** 1.05
    bg_zipf /= bg_zipf.sum()

    mixtures = rng.dirichlet(np.full(n_topics, alpha), size=n_docs).astype(np.float32)

    doc_terms = np.full((n_docs, max_unique), -1, np.int32)
    doc_tf = np.zeros((n_docs, max_unique), np.float32)
    for i in range(n_docs):
        # topic tokens
        k_topics = rng.choice(n_topics, size=doc_len, p=mixtures[i])
        offs = rng.choice(per_topic, size=doc_len, p=zipf)
        toks = n_bg + k_topics * per_topic + offs
        # background tokens (~25% of doc length)
        n_b = max(1, doc_len // 4)
        toks = np.concatenate([toks, rng.choice(n_bg, size=n_b, p=bg_zipf)])
        uniq, counts = np.unique(toks, return_counts=True)
        if uniq.shape[0] > max_unique:
            top = np.argsort(-counts)[:max_unique]
            uniq, counts = uniq[top], counts[top]
        doc_terms[i, : uniq.shape[0]] = uniq
        doc_tf[i, : uniq.shape[0]] = counts
    return TopicCorpus(doc_terms, doc_tf, vocab_size, n_topics, mixtures)


# ---------------------------------------------------------------- model batches
def lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
