"""Every phase-1 engine of the port's VectorIndex against the JAX package.

A JAX ``VectorIndex`` is carried across with ``interop.index_from_numpy``,
so both packages hold the very same codes, posting tables and vectors.
Stated tolerances:

* phase-1 scores of ``postings``, ``codes``, ``onehot`` and
  ``codes_pallas``: rtol/atol 1e-4 against JAX, the reference suite's own
  (``tests/test_engines.py``): each engine sums in its own order;
* searches: ``_assert_search_close`` (scores 1e-5, ids equal wherever the
  gold scores are more than 1e-5 apart);
* at ``page >= n_docs``, ``fused`` and ``fused_int8`` return ``codes``'s
  ids and scores bit for bit, as the reference's
  ``tests/test_quantized.py`` pins: every doc reaches the exact rescore.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import search as jsearch
from repro.core.filtering import BestFilter as JBest
from repro.core.filtering import TrimFilter as JTrim
from repro_torch import interop
from repro_torch.core import SearchParams, TrimFilter
from repro_torch.core import encoding as tenc
from repro_torch.core import postings as tpost
from repro_torch.core import search as tsearch
from repro_torch.core.filtering import BestFilter
from repro_torch.kernels.postings_walk import ref as walk_ref

from test_torch_search import _assert_search_close, _carry, _data

N_DOCS = 1200
COMPOSED = ["postings", "codes", "onehot", "codes_pallas"]
ENGINES = COMPOSED + ["fused", "fused_int8"]

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


def _query_tokens(jidx, Q, weighting, trim=JTrim(0.05), best=None):
    """JAX's query codes and weights, as numpy, fed to both packages."""
    _, qc, w = jidx.encode_queries(jnp.asarray(Q), trim, best, weighting)
    return np.array(qc), np.array(w)


@pytest.mark.parametrize("engine", COMPOSED)
@pytest.mark.parametrize("weighting", ["idf", "count"])
def test_phase1_engine_scores_match_jax(pair, engine, weighting):
    """The port's engine against JAX's same engine and JAX's postings."""
    jidx, tidx, Q = pair
    qc, w = _query_tokens(jidx, Q, weighting)
    want = np.asarray(jidx.phase1_scores(jnp.asarray(qc), jnp.asarray(w),
                                         engine, max_postings=None))
    gold = np.asarray(jidx.phase1_scores(jnp.asarray(qc), jnp.asarray(w),
                                         "postings", max_postings=None))
    got = tsearch.phase1_engine_scores(
        tidx.codes, tidx.postings, torch.from_numpy(qc),
        torch.from_numpy(w), engine, None, tidx.encoder.max_abs_bucket)
    assert got.dtype == torch.float32 and got.shape == (Q.shape[0], N_DOCS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), gold, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_postings", [1, 32, 200])
def test_truncated_postings_match_jax(pair, max_postings):
    """A capped posting window keeps the reference's semantics: the first
    ``max_postings`` entries of every list, and only lower bounds."""
    jidx, tidx, Q = pair
    qc, w = _query_tokens(jidx, Q, "idf", trim=None,
                          best=JBest(12))
    want = np.asarray(jidx.phase1_scores(jnp.asarray(qc), jnp.asarray(w),
                                         "postings", max_postings))
    got = tidx.phase1_scores(torch.from_numpy(qc), torch.from_numpy(w),
                             "postings", max_postings).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    full = tidx.phase1_scores(torch.from_numpy(qc), torch.from_numpy(w),
                              "postings", None).numpy()
    assert (got <= full + 1e-5).all()
    if max_postings == 1:
        assert (got < full - 1e-3).any()


def test_score_postings_single_query_and_idf(pair):
    """The one-query scorer with its own idf weighting equals the
    reference's, and the batch is its queries stacked."""
    from repro.core import postings as jpost

    jidx, tidx, Q = pair
    qc, w = _query_tokens(jidx, Q, "count")
    mask = w > 0
    want = np.asarray(jpost.score_postings(
        jidx.postings, jnp.asarray(qc[2]), jnp.asarray(mask[2]),
        max_postings=N_DOCS, weighting="idf"))
    got = tpost.score_postings(tidx.postings, torch.from_numpy(qc[2]),
                               torch.from_numpy(mask[2]), weighting="idf")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    batch = tpost.score_postings_batch(
        tidx.postings, torch.from_numpy(qc), torch.from_numpy(mask),
        weighting="idf")
    assert torch.equal(batch[2], got)
    with pytest.raises(ValueError, match="weighting"):
        tpost.score_postings(tidx.postings, torch.from_numpy(qc[0]),
                             torch.from_numpy(mask[0]), weighting="bm25")


@pytest.mark.parametrize("max_postings", [None, 32])
@pytest.mark.parametrize("step_entries", [None, 100])
def test_score_postings_batch_bit_equal_to_jax(pair, max_postings,
                                                step_entries, monkeypatch):
    """With weighting "count" the weights enter both packages the same
    way, so only the order of the adds could differ: one round per column,
    in column order, sums every (query, doc) as the reference's
    segment_sum does, bit for bit, however the columns are cut into
    steps.  The weights span six decades, so that another order shows."""
    from repro.core import postings as jpost

    if step_entries is not None:
        monkeypatch.setattr(walk_ref, "_STEP_ENTRIES", step_entries)
    jidx, tidx, Q = pair
    qc, _ = _query_tokens(jidx, Q, "count", trim=None)
    rng = np.random.default_rng(7)
    cw = (rng.random(qc.shape) * 10 ** rng.uniform(-3, 3, qc.shape)).astype(
        np.float32)
    mask = rng.random(qc.shape) < 0.8
    want = np.asarray(jpost.score_postings_batch(
        jidx.postings, jnp.asarray(qc), jnp.asarray(mask),
        max_postings=max_postings or N_DOCS, weighting="count",
        col_weights=jnp.asarray(cw)))
    got = tpost.score_postings_batch(
        tidx.postings, torch.from_numpy(qc), torch.from_numpy(mask),
        max_postings=max_postings, weighting="count",
        col_weights=torch.from_numpy(cw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    if max_postings is None:   # the same sums in reverse column order differ
        codes = np.asarray(jidx.codes)
        rev = np.zeros_like(want)
        for c in reversed(range(qc.shape[1])):
            rev += np.where(mask[:, None, c] & (codes[None, :, c]
                                                == qc[:, None, c]),
                            cw[:, None, c], np.float32(0))
        assert np.allclose(rev, want, rtol=1e-5, atol=0)
        assert not np.array_equal(rev, want)


def test_code_df_equals_df_lookup(pair):
    jidx, tidx, Q = pair
    from repro.core import postings as jpost

    qc, _ = _query_tokens(jidx, Q, "count")
    got = tpost.code_df(tidx.codes, torch.from_numpy(qc))
    assert got.dtype == torch.int32
    assert torch.equal(got, tpost.df_lookup(tidx.postings,
                                            torch.from_numpy(qc)))
    assert np.array_equal(got.numpy(), np.asarray(
        jpost.code_df(jnp.asarray(np.asarray(jidx.codes)), jnp.asarray(qc))))


@pytest.mark.parametrize("page", [N_DOCS, 320])
@pytest.mark.parametrize("engine", ENGINES)
def test_search_matches_jax(pair, engine, page):
    jidx, tidx, Q = pair
    want = jidx.search(jnp.asarray(Q), k=10, page=page, trim=JTrim(0.05),
                       engine=engine)
    got = tidx.search(torch.from_numpy(Q), k=10, page=page,
                      trim=TrimFilter(0.05), engine=engine)
    _assert_search_close(got, want)


@pytest.mark.parametrize("engine", ["fused", "fused_int8"])
def test_full_page_bit_equal_to_codes(pair, engine):
    """page >= n_docs: every doc reaches the exact rescore, so the fused
    engines return exactly what the codes engine returns."""
    _, tidx, Q = pair
    gold_i, gold_s = tidx.search(Q, k=10, page=2 * N_DOCS, engine="codes")
    ids, s = tidx.search(Q, k=10, page=2 * N_DOCS, engine=engine)
    assert torch.equal(ids, gold_i) and torch.equal(s, gold_s)


def test_engines_default_and_params():
    """``postings`` by default, as in the reference; SearchParams' fields
    and defaults are the reference's."""
    X, Q = _data(4)
    tidx = tsearch.VectorIndex.build(X[:300], device="cpu")
    want = tidx.search(Q, engine="postings", trim=TrimFilter(0.05))
    got = tidx.search(Q, trim=TrimFilter(0.05))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ref = {f.name: f.default for f in dataclasses.fields(jsearch.SearchParams)}
    port = {f.name: f.default for f in dataclasses.fields(SearchParams)}
    assert ref.keys() == port.keys()
    for name in ref:
        r, p = ref[name], port[name]
        assert (r is None) == (p is None) and (
            r is None or type(r).__name__ == type(p).__name__ and (
                not isinstance(r, (int, str, float)) or r == p)), name
    assert SearchParams().engine == "postings"


def test_fused_int8_ignores_tokens(pair):
    """fused_int8 reads no tokens: trim, best and weighting leave its
    answer as it is, as in the reference."""
    _, tidx, Q = pair
    base = tidx.search(Q, k=10, page=100, engine="fused_int8")
    other = tidx.search(Q, k=10, page=100, engine="fused_int8",
                        trim=TrimFilter(0.3), best=BestFilter(3),
                        weighting="count")
    assert torch.equal(base[0], other[0]) and torch.equal(base[1], other[1])
