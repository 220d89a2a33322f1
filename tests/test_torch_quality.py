"""The paper's claims C1-C5 (``tests/test_quality_claims.py``) on the
port's own pipeline, on the CPU: make_corpus -> build_lsa -> VectorIndex
-> search, against brute force and the More-Like-This baseline, at the
reference test's 3,000-doc size.  The metrics themselves are held to the
JAX package's on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import metrics as jmetrics
from repro_torch.core import (BestFilter, MLTIndex, TrimFilter, VectorIndex,
                              avg_diff, ndcg_k, precision_at_k)
from repro_torch.data import make_corpus
from repro_torch.lsa import build_lsa


@pytest.fixture(scope="module")
def setup():
    corpus = make_corpus(n_docs=3000, vocab_size=12000, n_topics=40, seed=7)
    pipe = build_lsa(corpus, n_features=128, device="cpu")
    idx = VectorIndex.build(pipe.doc_vectors, device="cpu")
    Q = pipe.doc_vectors[:32]
    gold_ids, gold_sims = idx.gold_topk(Q, 10)
    return corpus, idx, Q, gold_ids, gold_sims


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    ret = rng.integers(0, 30, size=(6, 10)).astype(np.int32)
    gold = rng.integers(0, 30, size=(6, 10)).astype(np.int32)
    rs = np.sort(rng.random((6, 10)).astype(np.float32))[:, ::-1].copy()
    gs = np.maximum(rs, np.sort(rng.random((6, 10)).astype(np.float32))
                    [:, ::-1])
    t = torch.from_numpy
    assert_allclose(precision_at_k(t(ret), t(gold)).numpy(),
                    np.asarray(jmetrics.precision_at_k(jnp.asarray(ret),
                                                       jnp.asarray(gold))))
    for ours, theirs in ((ndcg_k, jmetrics.ndcg_k),
                         (avg_diff, jmetrics.avg_diff)):
        assert_allclose(ours(t(rs), t(gs)).numpy(),
                        np.asarray(theirs(jnp.asarray(rs), jnp.asarray(gs))),
                        rtol=1e-6, atol=1e-7)


def test_c1_avg_diff_decreases_with_page(setup):
    _, idx, Q, _, gold_sims = setup
    diffs = []
    for page in [20, 80, 320, 640]:
        _, sims = idx.search(Q, k=10, page=page, trim=TrimFilter(0.05),
                             engine="codes")
        diffs.append(float(avg_diff(sims, gold_sims).mean()))
    assert all(a >= b - 1e-6 for a, b in zip(diffs, diffs[1:])), diffs
    assert diffs[0] > diffs[-1]


def test_c2_trim_005_close_to_unfiltered(setup):
    _, idx, Q, gold_ids, _ = setup
    ids_f, _ = idx.search(Q, k=10, page=320, engine="codes")
    ids_t, _ = idx.search(Q, k=10, page=320, trim=TrimFilter(0.05),
                          engine="codes")
    p_f = float(precision_at_k(ids_f, gold_ids).mean())
    p_t = float(precision_at_k(ids_t, gold_ids).mean())
    assert p_t >= p_f - 0.08, (p_t, p_f)
    _, _, w = idx.encode_queries(Q, TrimFilter(0.05), None, "idf")
    assert float((w > 0).sum(-1).float().mean()) < 0.75 * idx.n_features


def test_c2b_aggressive_trim_is_lossy(setup):
    _, idx, Q, _, gold_sims = setup
    _, s_mild = idx.search(Q, k=10, page=320, best=BestFilter(90),
                           engine="codes")
    _, s_aggr = idx.search(Q, k=10, page=320, best=BestFilter(6),
                           engine="codes")
    assert float(avg_diff(s_aggr, gold_sims).mean()) > \
        float(avg_diff(s_mild, gold_sims).mean())


def test_c3_beats_mlt_baseline(setup):
    corpus, idx, Q, gold_ids, gold_sims = setup
    nq = Q.shape[0]
    ids_ours, sims_ours = idx.search(Q, k=10, page=320,
                                     trim=TrimFilter(0.05), engine="codes")
    mlt = MLTIndex.build(corpus.doc_terms, corpus.doc_tf, corpus.vocab_size,
                         device="cpu")
    ids_mlt, _ = mlt.more_like_this(corpus.doc_terms[:nq],
                                    corpus.doc_tf[:nq], max_query_terms=25,
                                    k=10)
    sims_mlt = torch.gather(idx.vectors[:nq] @ idx.vectors.T, 1,
                            ids_mlt.long())
    assert float(precision_at_k(ids_ours, gold_ids).mean()) > \
        float(precision_at_k(ids_mlt, gold_ids).mean())
    assert float(ndcg_k(sims_ours, gold_sims).mean()) > \
        float(ndcg_k(sims_mlt, gold_sims).mean())
    assert float(avg_diff(sims_ours, gold_sims).mean()) < \
        float(avg_diff(sims_mlt, gold_sims).mean())


def test_c4_full_page_is_exact(setup):
    _, idx, Q, gold_ids, _ = setup
    ids, _ = idx.search(Q, k=10, page=idx.n_docs, engine="codes")
    assert torch.equal(ids, gold_ids)


def test_c5_query_side_only_filtering(setup):
    _, idx, Q, gold_ids, _ = setup
    codes_before = idx.codes.clone()
    p = []
    for f in [None, TrimFilter(0.05), TrimFilter(0.2)]:
        ids, _ = idx.search(Q, k=10, page=160, trim=f, engine="codes")
        p.append(float(precision_at_k(ids, gold_ids).mean()))
    assert torch.equal(idx.codes, codes_before)
    assert p[0] >= p[2] - 1e-6
