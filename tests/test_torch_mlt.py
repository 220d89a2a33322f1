"""repro_torch More-Like-This baseline against the JAX package, on the CPU.

The term postings are integer-exact and idf within 1e-6.  Query results:
ids equal wherever the reference's scores separate neighbouring ranks by
more than 1e-5, scores within rtol 1e-6 / atol 1e-5 (the sums over a
doc's matching terms run in another order than the reference's
segment_sum; on the CPU they are usually bit-equal).  Both the port's
own build and an index carried across with ``interop.mlt_from_numpy``
are held, with exact and truncated posting windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from repro.core import MLTIndex as JaxMLT
from repro_torch import interop
from repro_torch.core import MLTIndex
from repro_torch.data import make_corpus


@pytest.fixture(scope="module")
def built():
    corpus = make_corpus(n_docs=400, vocab_size=3000, n_topics=10, seed=0)
    jm = JaxMLT.build(jnp.asarray(corpus.doc_terms),
                      jnp.asarray(corpus.doc_tf), corpus.vocab_size)
    tm = MLTIndex.build(corpus.doc_terms, corpus.doc_tf, corpus.vocab_size,
                        device="cpu")
    return corpus, jm, tm


def _assert_mlt_parity(got, want, tol=1e-5):
    i_g, s_g = (np.asarray(x) for x in got)
    i_w, s_w = (np.asarray(x) for x in want)
    assert i_g.dtype == np.int32 and s_g.dtype == np.float32
    assert_allclose(s_g, s_w, rtol=1e-6, atol=tol)
    sep = np.ones(s_w.shape, bool)
    tie = np.abs(s_w[:, :-1] - s_w[:, 1:]) <= tol
    sep[:, 1:] &= ~tie
    sep[:, :-1] &= ~tie
    assert sep.any()
    assert np.array_equal(i_g[sep], i_w[sep])


def test_build_matches(built):
    _, jm, tm = built
    jp, tp = jm.postings, tm.postings
    for name in ("sorted_terms", "sorted_docs", "sorted_tf"):
        assert np.array_equal(getattr(tp, name).numpy(),
                              np.asarray(getattr(jp, name))), name
    assert_allclose(tp.idf.numpy(), np.asarray(jp.idf), rtol=0, atol=1e-6)
    assert tp.n_docs == jp.n_docs


@pytest.mark.parametrize("mqt,k,max_postings", [
    (25, 10, 4096), (5, 5, 4096), (50, 10, 4096), (25, 10, 7)])
def test_more_like_this_matches(built, mqt, k, max_postings):
    corpus, jm, tm = built
    qt, qtf = corpus.doc_terms[:16], corpus.doc_tf[:16]
    want = jm.more_like_this(jnp.asarray(qt), jnp.asarray(qtf),
                             max_query_terms=mqt, k=k,
                             max_postings=max_postings)
    got = tm.more_like_this(qt, qtf, max_query_terms=mqt, k=k,
                            max_postings=max_postings)
    _assert_mlt_parity(got, want)


def test_carried_index_and_padded_queries(built):
    """An index carried across from the JAX leaves answers as the JAX one,
    for queries with more pads than terms and one with no term at all."""
    corpus, jm, _ = built
    p = jm.postings
    tm = interop.mlt_from_numpy(
        *(np.asarray(a) for a in (p.sorted_terms, p.sorted_docs, p.sorted_tf,
                                  p.idf, jm.doc_terms, jm.doc_tf)),
        device="cpu")
    qt = corpus.doc_terms[20:28].copy()
    qtf = corpus.doc_tf[20:28].copy()
    qt[:, 10:] = -1
    qtf[:, 10:] = 0
    qt[3] = -1
    want = jm.more_like_this(jnp.asarray(qt), jnp.asarray(qtf), k=10)
    got = tm.more_like_this(qt, qtf, k=10)
    assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-6,
                    atol=1e-5)
    assert (np.asarray(got[1])[3] == 0).all()


def test_self_retrieval(built):
    """``tests/test_mlt.py``: a document's own text is its best match."""
    corpus, _, tm = built
    ids, _ = tm.more_like_this(corpus.doc_terms[:8], corpus.doc_tf[:8],
                               max_query_terms=25, k=5)
    assert (ids[:, 0].numpy() == np.arange(8)).all()


@pytest.mark.parametrize("mqt,max_postings", [(25, 4096), (50, 7)])
def test_scores_bit_equal_to_sequential_scatter(built, mqt, max_postings):
    """The rounds sum every (query, doc) as a sequential scatter in
    (query, selected term) order does, bit for bit.  They may: within a
    term's posting list each doc appears once, checked here first.  The
    per-entry weights are torch's own (the order of the adds is what is
    under test, not log1p)."""
    import torch

    from repro_torch.core.rerank import stable_topk

    corpus, _, tm = built
    p = tm.postings
    terms, docs = p.sorted_terms.numpy(), p.sorted_docs.numpy()
    real = terms < corpus.vocab_size
    pairs = terms[real].astype(np.int64) * p.n_docs + docs[real]
    assert np.unique(pairs).size == pairs.size

    qt, qtf = corpus.doc_terms[:16], corpus.doc_tf[:16]
    got = tm.scores(qt, qtf, max_query_terms=mqt, max_postings=max_postings)
    tq = torch.from_numpy(qt).long()
    tf = torch.from_numpy(qtf).float()
    tid = tq.clamp(min=0)
    tfidf = torch.where(tq >= 0, (1.0 + torch.log1p(tf)) * p.idf[tid],
                        float("-inf"))
    sel_w, sel_pos = stable_topk(tfidf, min(mqt, qt.shape[1]))
    sel, sel_w = torch.gather(tid, 1, sel_pos).numpy(), sel_w.numpy()
    entry_w = (1.0 + torch.log1p(p.sorted_tf)).numpy()
    idf = p.idf.numpy()
    want = np.zeros((qt.shape[0], p.n_docs), np.float32)
    for q in range(qt.shape[0]):
        for j in range(sel.shape[1]):
            if not np.isfinite(sel_w[q, j]):
                continue
            lo, hi = np.searchsorted(terms, sel[q, j], side="left"), \
                np.searchsorted(terms, sel[q, j], side="right")
            for e in range(lo, min(hi, lo + max_postings)):
                want[q, docs[e]] += idf[sel[q, j]] * entry_w[e]
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
