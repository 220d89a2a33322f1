"""The repro_torch search slice against the JAX reference.

A JAX ``VectorIndex`` is carried across with ``interop.index_from_numpy``
so that both packages search the very same index bits with
``engine="fused"`` (every other engine: ``tests/test_torch_engines.py``).  Stated tolerances: final scores within 1e-5 (the fp32
rescore reduces in another order), ids equal wherever neighbouring gold
scores are more than 1e-5 apart, query codes exact, idf weights rtol 1e-6,
``normalize`` atol 1e-6, ``exact_scores`` atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import rerank as jrr
from repro.core import search as jsearch
from repro.core.filtering import BestFilter as JBest
from repro.core.filtering import TrimFilter as JTrim
from repro_torch import interop
from repro_torch.core import TrimFilter, VectorIndex
from repro_torch.core import encoding as tenc
from repro_torch.core import rerank as trr
from repro_torch.core.filtering import BestFilter

N_DOCS, N_FEAT, N_Q = 1200, 32, 9
TOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_DOCS, N_FEAT)).astype(np.float32)
    src = rng.integers(0, N_DOCS, size=N_Q)
    Q = (X[src] / np.linalg.norm(X[src], axis=1, keepdims=True)
         + 0.05 * rng.normal(size=(N_Q, N_FEAT))).astype(np.float32)
    return X, Q


def _carry(jidx, te):
    return interop.index_from_numpy(
        np.asarray(jidx.vectors), np.asarray(jidx.codes),
        np.asarray(jidx.postings.post_docs),
        np.asarray(jidx.postings.post_codes), te,
        index_best=jidx.index_best, device="cpu")


ENCODERS = [  # (JAX encoder, the port's same encoder)
    (jenc.RoundingEncoder(2), tenc.RoundingEncoder(2)),
    (jenc.CombinedEncoder(jenc.RoundingEncoder(1), jenc.IntervalEncoder(0.1)),
     tenc.CombinedEncoder(tenc.RoundingEncoder(1), tenc.IntervalEncoder(0.1))),
]


@pytest.fixture(scope="module", params=ENCODERS,
                ids=lambda e: e[0].scheme_id)
def pair(request):
    X, Q = _data()
    je, te = request.param
    jidx = jsearch.VectorIndex.build(jnp.asarray(X), encoder=je)
    return jidx, _carry(jidx, te), Q


def _assert_search_close(got, want):
    ids_g, s_g = (np.asarray(x) for x in got)
    ids_w, s_w = (np.asarray(x) for x in want)
    assert ids_g.shape == ids_w.shape and ids_g.dtype == np.int32
    np.testing.assert_allclose(s_g, s_w, atol=TOL, rtol=0)
    gap = np.abs(np.diff(s_w, axis=1))
    left = np.concatenate([np.full((s_w.shape[0], 1), np.inf), gap], 1)
    right = np.concatenate([gap, np.full((s_w.shape[0], 1), np.inf)], 1)
    sep = (left > TOL) & (right > TOL)
    assert sep.mean() > 0.5
    assert np.array_equal(ids_g[sep], ids_w[sep])


@pytest.mark.parametrize("page", [N_DOCS, 320])
@pytest.mark.parametrize("trim", [None, 0.05])
def test_fused_search_matches_jax(pair, page, trim):
    jidx, tidx, Q = pair
    want = jidx.search(jnp.asarray(Q), k=10, page=page,
                       trim=None if trim is None else JTrim(trim),
                       engine="fused")
    got = tidx.search(torch.from_numpy(Q), k=10, page=page,
                      trim=None if trim is None else TrimFilter(trim),
                      engine="fused")
    _assert_search_close(got, want)
    if page >= N_DOCS:
        # a full page is exact: the port equals its own brute force
        gold_i, gold_s = tidx.gold_topk(Q, k=10)
        assert np.array_equal(got[0].numpy(), gold_i.numpy())
        np.testing.assert_allclose(got[1].numpy(), gold_s.numpy(), atol=TOL,
                                   rtol=0)


def test_encode_queries_matches_jax(pair):
    jidx, tidx, Q = pair
    jq, jc, jw = jidx.encode_queries(jnp.asarray(Q), JTrim(0.05), JBest(20),
                                     "idf")
    tq, tc, tw = tidx.encode_queries(torch.from_numpy(Q), TrimFilter(0.05),
                                     BestFilter(20), "idf")
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    # codes of reference-normalized queries are exact; the normalize ulp
    # may move a value across a bucket edge, so bound the share there
    assert (tc.numpy() != np.asarray(jc)).mean() <= 1e-3
    same = tc.numpy() == np.asarray(jc)
    np.testing.assert_allclose(tw.numpy()[same], np.asarray(jw)[same],
                               rtol=1e-6, atol=0)
    _, cc, cw = tidx.encode_queries(torch.from_numpy(Q), None, None, "count")
    assert (cw.numpy() == 1.0).all()
    with pytest.raises(ValueError, match="weighting"):
        tidx.encode_queries(torch.from_numpy(Q), None, None, "bm25")


def test_carried_index_holds_the_same_bits(pair):
    jidx, tidx, _ = pair
    assert tidx.n_docs == jidx.n_docs and tidx.n_features == jidx.n_features
    assert tidx.device == torch.device("cpu")
    assert np.array_equal(tidx.codes.numpy(), np.asarray(jidx.codes))
    assert np.array_equal(tidx.postings.post_docs.numpy(),
                          np.asarray(jidx.postings.post_docs))
    assert np.array_equal(tidx.vectors.numpy(), np.asarray(jidx.vectors))


@pytest.mark.parametrize("enc_pair", [
    (jenc.RoundingEncoder(2), tenc.RoundingEncoder(2)),
    (jenc.CombinedEncoder(jenc.RoundingEncoder(1), jenc.IntervalEncoder(0.1)),
     tenc.CombinedEncoder(tenc.RoundingEncoder(1),
                          tenc.IntervalEncoder(0.1)))],
    ids=["P2", "P1+I10"])
@pytest.mark.parametrize("index_best", [None, 12])
def test_build_from_raw_vectors(enc_pair, index_best):
    """The port's own build: normalize may differ by an ulp, so at most
    1e-4 of the codes may sit in a neighbouring bucket; search still
    agrees with the JAX index."""
    je, te = enc_pair
    X, Q = _data(1)
    jidx = jsearch.VectorIndex.build(jnp.asarray(X), encoder=je,
                                     index_best=index_best)
    tidx = VectorIndex.build(X, encoder=te, index_best=index_best,
                             device="cpu")
    assert tidx.codes.dtype == te.code_dtype
    assert (tidx.codes.numpy() != np.asarray(jidx.codes)).mean() <= 1e-4
    np.testing.assert_allclose(tidx.vectors.numpy(), np.asarray(jidx.vectors),
                               atol=1e-6, rtol=0)
    _assert_search_close(
        tidx.search(Q, k=10, page=N_DOCS, engine="fused"),
        jidx.search(jnp.asarray(Q), k=10, page=N_DOCS, engine="fused"))


def test_unknown_engine_and_params():
    X, _ = _data()
    tidx = VectorIndex.build(X[:50], device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tidx.search(X[:2], engine="nope")
    ids, s = tidx.search(X[0], k=100, page=500)   # "postings" by default
    assert ids.shape == s.shape == (1, 50)        # k and page clamp to d


# ------------------------------------------------------------ phase 2
def test_normalize_and_exact_scores_close():
    X, Q = _data(2)
    np.testing.assert_allclose(trr.normalize(torch.from_numpy(X)).numpy(),
                               np.asarray(jrr.normalize(jnp.asarray(X))),
                               atol=1e-6, rtol=0)
    V = np.array(jrr.normalize(jnp.asarray(X)))
    q = np.array(jrr.normalize(jnp.asarray(Q)))
    ids = np.random.default_rng(0).integers(0, N_DOCS, size=(N_Q, 10))
    want = np.asarray(jrr.exact_scores(jnp.asarray(V), jnp.asarray(ids),
                                       jnp.asarray(q)))
    got = trr.exact_scores(torch.from_numpy(V), torch.from_numpy(ids),
                           torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rerank_and_brute_force_match_jax():
    X, Q = _data(3)
    V = np.array(jrr.normalize(jnp.asarray(X)))
    q = np.array(jrr.normalize(jnp.asarray(Q)))
    cand = np.random.default_rng(1).choice(N_DOCS, size=(N_Q, 200))
    cand = cand.astype(np.int32)
    want = jrr.rerank_topk(jnp.asarray(V), jnp.asarray(cand), jnp.asarray(q),
                           10)
    got = trr.rerank_topk(torch.from_numpy(V), torch.from_numpy(cand),
                          torch.from_numpy(q), 10)
    _assert_search_close(got, want)
    for block in (64, 500, 4096):
        got = trr.brute_force_topk(torch.from_numpy(V), torch.from_numpy(q),
                                   10, block=block)
        _assert_search_close(got, jrr.brute_force_topk(
            jnp.asarray(V), jnp.asarray(q), 10))


def test_stable_topk_breaks_ties_to_lower_index():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, pos = trr.stable_topk(s, 4)
    assert pos.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
