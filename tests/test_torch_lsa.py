"""repro_torch corpus and LSA against the JAX package, on the CPU.

The corpus is byte-identical (a numpy copy of the generator).  tf-idf
agrees within 1e-6; the bag products within the reference suite's own
tolerances (``tests/test_lsa.py``), whatever the doc block.  The
randomized SVD cannot share the JAX package's random draws or its QR and
SVD column signs, so it is fed JAX's test matrix and held on sign-free
quantities: singular values (rtol 1e-3, as ``tests/test_lsa.py``), the
doc-doc cosines (atol 1e-4: float32 power iterations and QR in another
order; about 4e-6 is seen) and nearest neighbours.  ``embed`` /
``fold_in`` run on a model carried across with
``interop.lsa_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.data import make_corpus as jax_make_corpus
from repro.lsa import build_lsa as jax_build_lsa
from repro.lsa import fit_tfidf as jax_fit_tfidf
from repro.lsa import randomized_svd as jax_randomized_svd
from repro.lsa import transform as jax_transform
from repro.lsa.svd import matvec_bags as jax_matvec
from repro.lsa.svd import rmatvec_bags as jax_rmatvec
from repro_torch import interop
from repro_torch.data import make_corpus
from repro_torch.lsa import build_lsa, fit_tfidf, transform
from repro_torch.lsa import svd as tsvd


@pytest.mark.parametrize("kw", [
    dict(n_docs=300, vocab_size=2000, n_topics=8, seed=2),
    dict(n_docs=200, vocab_size=100000, n_topics=400, seed=0),
    dict(n_docs=150, vocab_size=500, n_topics=5, doc_len=40, max_unique=16,
         seed=11)])
def test_corpus_byte_identical(kw):
    got, want = make_corpus(**kw), jax_make_corpus(**kw)
    for name in ("doc_terms", "doc_tf", "doc_topics"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (got.vocab_size, got.n_topics) == (want.vocab_size, want.n_topics)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=400, vocab_size=3000, n_topics=10, seed=3)


def test_tfidf_within_1e6(corpus):
    terms, tf = corpus.doc_terms, corpus.doc_tf
    jm = jax_fit_tfidf(jnp.asarray(terms), corpus.vocab_size)
    tm = fit_tfidf(torch.from_numpy(terms), corpus.vocab_size)
    assert_allclose(tm.idf.numpy(), np.asarray(jm.idf), rtol=0, atol=1e-6)
    want = np.asarray(jax_transform(jm, jnp.asarray(terms), jnp.asarray(tf)))
    got = transform(tm, torch.from_numpy(terms), torch.from_numpy(tf))
    assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.numpy()[terms < 0] == 0).all()


def _dense(terms, weights, vocab):
    A = np.zeros((terms.shape[0], vocab), np.float32)
    for i in range(terms.shape[0]):
        for t, w in zip(terms[i], weights[i]):
            if t >= 0:
                A[i, t] += w
    return A


@pytest.mark.parametrize("block", [None, 1, 7, 64])
def test_bag_products_blocked_and_unblocked(block):
    """A @ Y and A.T @ X against the dense oracle and the JAX package at
    ``tests/test_lsa.py``'s tolerances, for any doc block."""
    rng = np.random.default_rng(0)
    terms = rng.integers(-1, 50, size=(20, 12)).astype(np.int32)
    weights = rng.random((20, 12)).astype(np.float32) * (terms >= 0)
    Y = rng.normal(size=(50, 7)).astype(np.float32)
    X = rng.normal(size=(20, 7)).astype(np.float32)
    A = _dense(terms, weights, 50)
    t, w = torch.from_numpy(terms), torch.from_numpy(weights)
    got = tsvd.matvec_bags(t, w, torch.from_numpy(Y), block=block).numpy()
    assert_allclose(got, A @ Y, rtol=1e-4, atol=1e-5)
    assert_allclose(got, np.asarray(jax_matvec(
        jnp.asarray(terms), jnp.asarray(weights), jnp.asarray(Y))),
        rtol=1e-4, atol=1e-5)
    got2 = tsvd.rmatvec_bags(t, w, torch.from_numpy(X), 50,
                             block=block).numpy()
    assert_allclose(got2, A.T @ X, rtol=1e-4, atol=1e-5)
    assert_allclose(got2, np.asarray(jax_rmatvec(
        jnp.asarray(terms), jnp.asarray(weights), jnp.asarray(X), 50)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("block", [None, 7, 64])
def test_rmatvec_bags_fixed_order(block):
    """A.T @ X is summed in one fixed order: within a doc block each
    term's contributions in (doc, slot) order, then the block sums in
    block order -- bit-equal to that sequential sum in numpy, with weights
    over six decades so that another order shows."""
    rng = np.random.default_rng(1)
    d, T, r, V = 300, 12, 5, 40
    terms = rng.integers(-1, V, size=(d, T)).astype(np.int32)
    weights = (rng.random((d, T)) * 10 ** rng.uniform(-3, 3, (d, T))
               ).astype(np.float32)
    X = rng.normal(size=(d, r)).astype(np.float32)
    got = tsvd.rmatvec_bags(torch.from_numpy(terms), torch.from_numpy(weights),
                            torch.from_numpy(X), V, block=block).numpy()
    step = block or d
    want = np.zeros((V + 1, r), np.float32)
    for lo in range(0, d, step):
        part = {}
        for i in range(lo, min(lo + step, d)):
            for j in range(T):
                t = terms[i, j] if terms[i, j] >= 0 else V
                c = weights[i, j] * X[i]
                part[t] = part[t] + c if t in part else c
        for t, v in part.items():
            want[t] = want[t] + v
    assert np.array_equal(got, want[:V])


def _jax_omega(seed, vocab, r):
    """The test matrix JAX's randomized_svd draws (``svd.py``)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (vocab, r),
                                      jnp.float32))


@pytest.mark.parametrize("block", [None, 33])
def test_randomized_svd_on_jax_omega(corpus, block):
    k, over, n_iter, seed = 24, 16, 3, 0
    terms = jnp.asarray(corpus.doc_terms)
    jw = jax_transform(jax_fit_tfidf(terms, corpus.vocab_size), terms,
                       jnp.asarray(corpus.doc_tf))
    want = jax_randomized_svd(terms, jw, corpus.vocab_size, k=k,
                              oversample=over, n_iter=n_iter, seed=seed)
    omega = torch.from_numpy(_jax_omega(seed, corpus.vocab_size, k + over))
    got = tsvd.randomized_svd_from_omega(
        torch.from_numpy(corpus.doc_terms), torch.from_numpy(np.array(jw)),
        omega, k=k, n_iter=n_iter, block=block)
    assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-3)
    G, W = got.doc_vecs.numpy(), np.asarray(want.doc_vecs)
    assert_allclose(np.linalg.norm(G, axis=1), 1.0, rtol=1e-5)
    sims_g, sims_w = G @ G.T, W @ W.T
    assert_allclose(sims_g, sims_w, rtol=0, atol=1e-4)
    np.fill_diagonal(sims_g, -1)
    np.fill_diagonal(sims_w, -1)
    # nearest neighbours agree wherever the reference's first two are apart
    top2 = np.sort(sims_w, axis=1)[:, -2:]
    sep = top2[:, 1] - top2[:, 0] > 2e-4
    assert sep.mean() > 0.9
    assert (sims_g.argmax(1)[sep] == sims_w.argmax(1)[sep]).all()


def test_randomized_svd_matches_numpy():
    """``tests/test_lsa.py``'s oracle case, with the port's own draws."""
    rng = np.random.default_rng(1)
    d, v, k = 120, 80, 10
    terms = rng.integers(0, v, size=(d, 16)).astype(np.int32)
    weights = rng.random((d, 16)).astype(np.float32)
    model = tsvd.randomized_svd(torch.from_numpy(terms),
                                torch.from_numpy(weights), v, k=k,
                                oversample=20, n_iter=6)
    _, s_np, _ = np.linalg.svd(_dense(terms, weights, v), full_matrices=False)
    assert_allclose(model.s.numpy(), s_np[:k], rtol=1e-3)
    assert_allclose(np.linalg.norm(model.doc_vecs.numpy(), axis=1), 1.0,
                    rtol=1e-5)


def test_fold_in_on_a_carried_model():
    """embed (tf-idf transform + fold_in) on the JAX model's own arrays
    equals the JAX package's, and folding a training doc lands on its own
    vector (within 1e-6: the norm and bag sums run in another order)."""
    corpus = make_corpus(n_docs=300, vocab_size=2000, n_topics=8, seed=2)
    jp = jax_build_lsa(corpus, n_features=32)
    tp = interop.lsa_from_numpy(np.asarray(jp.tfidf.idf), np.asarray(jp.lsa.v),
                                np.asarray(jp.lsa.s),
                                np.asarray(jp.lsa.doc_vecs), device="cpu")
    want = np.asarray(jp.embed(jnp.asarray(corpus.doc_terms),
                               jnp.asarray(corpus.doc_tf)))
    got = tp.embed(corpus.doc_terms, corpus.doc_tf).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got * tp.doc_vectors.numpy()).sum(-1).mean() > 0.98


def test_pipeline_neighbours_share_topics():
    """``tests/test_lsa.py``'s topic check on the port's own pipeline."""
    corpus = make_corpus(n_docs=400, vocab_size=3000, n_topics=10, seed=3)
    pipe = build_lsa(corpus, n_features=24, device="cpu")
    V = pipe.doc_vectors.numpy()
    sims = V @ V.T
    np.fill_diagonal(sims, -1)
    nn = sims.argmax(1)
    mix = corpus.doc_topics
    mix = mix / np.linalg.norm(mix, axis=1, keepdims=True)
    nn_topic_sim = (mix * mix[nn]).sum(-1).mean()
    rand_topic_sim = (mix * np.roll(mix, 37, axis=0)).sum(-1).mean()
    assert nn_topic_sim > rand_topic_sim + 0.2
