"""repro_torch's two-phase candidate retrieval (``serve/retrieval.py``)
against the JAX package's, on the CPU.

* ``encode_candidates``: unit vectors within VEC_TOL, codes equal to the
  reference's (one bucket apart only where the two roundings of a value
  straddle a bucket edge), for the four recsys widths (D 10, 16, 18, 32);
* the phase-1 page of ``retrieval_step`` at page 512 over 20,000 seeded
  candidates (the reference's table, carried across): ids exactly the
  reference's (``score_codes`` plus ``jax.lax.top_k``), in order -- the
  scores are whole counts, so no tolerance applies;
* the final top-k ids the reference's wherever the exact scores are not
  within TIE_TOL of a neighbour's, and the scores within SCORE_TOL;
  ``brute_force_retrieval`` likewise against JAX's;
* ``tests/test_archs.py::test_recsys_retrieval_integration`` on the port
  for each recsys model (user tower, page = N: ids equal to the brute
  force's), and its ids against JAX's on the same user vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codes as jcodes
from repro.core import filtering as jfilt
from repro.core.encoding import RoundingEncoder as JRoundingEncoder
from repro.core.rerank import normalize as jnormalize
from repro.serve import retrieval as jret
from repro_torch.configs import get_arch
from repro_torch.data import recsys_batch
from repro_torch.serve import retrieval as tret

VEC_TOL = 1e-6          # measured <= 1.8e-7
SCORE_TOL = 1e-6        # measured <= 2.4e-7
TIE_TOL = 1e-6          # scores closer than this may swap
EDGE = 1e-4             # x * 100 this near a half: either bucket (1 code
                        # of 1,280,000 measured, at D 32)
N_CAND = 20_000
PAGE = 512
K = 100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cands(D, n=N_CAND, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _users(D, Q=4, seed=1):
    return np.random.default_rng(seed).normal(size=(Q, D)).astype(np.float32)


def _reference_page(u, codes, page):
    """The reference ``retrieval_step``'s phase 1, step for step."""
    enc = JRoundingEncoder(2)
    q = jnormalize(jnp.asarray(u))
    qcodes = enc.encode(q)
    mask = jfilt.expand_mask(jfilt.feature_mask(q, trim=jfilt.TrimFilter(0.05)),
                             qcodes.shape[-1])
    w = jnp.where(mask, 1.0, 0.0)
    _, cand = jax.lax.top_k(jcodes.score_codes(codes, qcodes, w), page)
    return np.asarray(cand)


def _same_away_from_ties(ids, scores, want_ids, want_scores, tol):
    """Equal ids at every rank whose reference score is more than ``tol``
    from both neighbours'."""
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    s = np.asarray(want_scores)
    np.testing.assert_allclose(np.asarray(scores), s, rtol=SCORE_TOL, atol=SCORE_TOL)
    gap = np.full(s.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], s[:, :-1] - s[:, 1:])
    gap[:, :-1] = np.minimum(gap[:, :-1], s[:, :-1] - s[:, 1:])
    clear = gap > tol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids[clear], want_ids[clear])


@pytest.mark.parametrize("D", [10, 16, 18, 32])
def test_encode_and_page_equal_the_reference(D):
    cand, u = _cands(D), _users(D)
    jv, jc = jret.encode_candidates(jnp.asarray(cand))
    tv, tc = tret.encode_candidates(torch.from_numpy(cand))
    assert tc.dtype == torch.int8 and tc.shape == (N_CAND, D)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=VEC_TOL)
    # codes equal but where a unit vector's two roundings straddle a
    # bucket edge (x * 100 within EDGE of a half): there one bucket apart
    jc = np.asarray(jc)
    scaled = np.abs(np.asarray(jv, np.float64) * 100)
    edge = np.abs(scaled - np.floor(scaled) - 0.5) < EDGE
    assert (tc.numpy() == jc)[~edge].all()
    assert np.abs(tc.numpy().astype(int) - jc)[edge].max(initial=0) <= 1
    # phase 2 and the page on the reference's table, carried across
    tv, tc = torch.from_numpy(np.asarray(jv)), torch.from_numpy(jc)
    _, page = tret.retrieval_page(torch.from_numpy(u), tc, page=PAGE)
    assert page.shape == (4, PAGE)
    np.testing.assert_array_equal(page.numpy(), _reference_page(u, jc, PAGE))
    ids, scores = tret.retrieval_step(torch.from_numpy(u), tv, tc, page=PAGE, k=K)
    assert ids.dtype == torch.int32 and ids.shape == (4, K)
    want = jret.retrieval_step(jnp.asarray(u), jv, jc, page=PAGE, k=K)
    _same_away_from_ties(ids, scores, *want, TIE_TOL)
    # every answer is a member of the page, ranked by exact score
    assert all(set(ids[q].tolist()) <= set(page[q].tolist()) for q in range(4))
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())
    bids, bscores = tret.brute_force_retrieval(torch.from_numpy(u), tv, k=K)
    _same_away_from_ties(bids, bscores, *jret.brute_force_retrieval(
        jnp.asarray(u), jv, k=K), TIE_TOL)


def test_page_n_equals_brute_force_bit_for_bit():
    """At page = N the two-phase answer is the brute force's: on these
    inputs no two candidates near the top lie within the two ranking
    products' rounding of each other, so the ids are equal, and both
    report ``exact_scores`` of their ids, so the scores are equal bits."""
    cand, u = _cands(18, n=3000, seed=5), _users(18, Q=3, seed=6)
    tv, tc = tret.encode_candidates(torch.from_numpy(cand))
    ids, scores = tret.retrieval_step(torch.from_numpy(u), tv, tc, page=3000, k=50)
    bids, bscores = tret.brute_force_retrieval(torch.from_numpy(u), tv, k=50)
    assert torch.equal(ids, bids) and torch.equal(scores, bscores)


def _np_batch(arch, B, rng):
    cfg = arch.smoke_cfg
    if arch.seq:
        return recsys_batch(rng, B, 1, [cfg.item_vocab], seq_len=cfg.seq_len)
    return recsys_batch(rng, B, cfg.n_sparse, cfg.vocab_sizes)


@pytest.mark.parametrize("arch_id", ["xdeepfm", "autoint", "din", "bst"])
def test_recsys_retrieval_integration(arch_id):
    """The paper's two-phase search as the recsys candidate generator:
    the user tower, 2,000 candidates, page = N exact; the JAX package's
    ``retrieval_step`` on the same user vectors gives the same ids
    (``test_torch_recsys`` holds the user towers to JAX's)."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_cfg
    model = arch.init_fn(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    b = _np_batch(arch, 4, rng)
    cand = rng.normal(size=(2000, cfg.embed_dim)).astype(np.float32)
    with torch.no_grad():
        u = arch.user_fn(model, {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
        vecs, codes = tret.encode_candidates(torch.from_numpy(cand))
        ids, scores = tret.retrieval_step(u, vecs, codes, page=2000, k=10)
        gold_ids, gold_s = tret.brute_force_retrieval(u, vecs, k=10)
    assert u.shape == (4, cfg.embed_dim)
    assert (ids.numpy() == gold_ids.numpy()).all()          # page=N: exact
    jv, jc = jret.encode_candidates(jnp.asarray(cand))
    want = jret.retrieval_step(jnp.asarray(u.numpy()), jv, jc, page=2000, k=10)
    _same_away_from_ties(ids, scores, *want, TIE_TOL)
