"""repro_torch phase-2 rerank kernel wrappers against the JAX package, on
the CPU.

Scores within the reference suite's rtol 1e-4 / atol 5e-5
(``tests/test_kernels.py``) of JAX's oracle and of its Pallas kernel in
interpret mode (``force_pallas=True``).  ``rerank_topk`` selects the ids
the JAX wrapper and the port's core ``rerank_topk`` select, ties to the
lower page position, and reports the core path's exact scores.  On the
CPU the wrappers run the plain versions; the CUDA kernel is held to them
by ``tests/test_torch_cuda.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core.rerank import normalize as jnormalize
from repro.kernels.rerank_topk import ops as jops
from repro.kernels.rerank_topk.ref import rerank_scores_ref as jax_ref
from repro_torch.core import rerank as trerank
from repro_torch.kernels.rerank_topk import ops, ref


@pytest.mark.parametrize("shape", [(1, 16, 8), (3, 300, 64), (8, 512, 400),
                                   (2, 77, 33)])
def test_rerank_scores_vs_jax(shape):
    q, p, n = shape
    rng = np.random.default_rng(sum(shape))
    CV = rng.normal(size=(q, p, n)).astype(np.float32)
    QV = rng.normal(size=(q, n)).astype(np.float32)
    got = ops.rerank_scores(torch.from_numpy(CV), torch.from_numpy(QV))
    assert got.dtype == torch.float32 and got.shape == (q, p)
    for want in (jax_ref(jnp.asarray(CV), jnp.asarray(QV)),
                 jops.rerank_scores(jnp.asarray(CV), jnp.asarray(QV),
                                    force_pallas=True)):
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-5)


def test_candidate_scores_equal_gathered_scores():
    """The table form (what the CUDA kernel computes) is the gathered
    form on ``vectors[cand_ids]``, int32 or int64 ids."""
    rng = np.random.default_rng(4)
    V = torch.from_numpy(rng.normal(size=(300, 40)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, size=(5, 70)))
    Q = torch.from_numpy(rng.normal(size=(5, 40)).astype(np.float32))
    want = ref.rerank_scores_ref(V[ids], Q)
    assert torch.equal(ops.candidate_scores(V, ids, Q), want)
    assert torch.equal(ops.candidate_scores(V, ids.to(torch.int32), Q), want)


@pytest.mark.parametrize("q,d,n,page,k", [(4, 200, 32, 64, 5),
                                          (7, 1000, 400, 320, 10),
                                          (2, 50, 3, 50, 50)])
def test_rerank_topk_vs_jax_and_core(q, d, n, page, k):
    rng = np.random.default_rng(q + d)
    V = np.array(jnormalize(jnp.asarray(
        rng.normal(size=(d, n)).astype(np.float32))))
    ids = rng.integers(0, d, size=(q, page)).astype(np.int32)
    Q = np.array(jnormalize(jnp.asarray(
        rng.normal(size=(q, n)).astype(np.float32))))
    Vt, idt, Qt = map(torch.from_numpy, (V, ids, Q))
    i_g, s_g = ops.rerank_topk(Vt, idt, Qt, k)
    assert i_g.dtype == torch.int32 and i_g.shape == (q, k)
    i_c, s_c = trerank.rerank_topk(Vt, idt, Qt, k)
    assert torch.equal(i_g, i_c) and torch.equal(s_g, s_c)
    i_j, s_j = jops.rerank_topk(jnp.asarray(V), jnp.asarray(ids),
                                jnp.asarray(Q), k=k, force_pallas=True)
    # ids equal away from near-ties of the plain scores
    plain = ref.candidate_scores_ref(Vt, idt, Qt).numpy()
    kth = np.sort(plain, axis=1)[:, ::-1]
    apart = (kth[:, k - 1] - kth[:, k] > 5e-5) if k < page else \
        np.ones(q, bool)
    assert apart.any()
    assert np.array_equal(i_g.numpy()[apart], np.asarray(i_j)[apart])
    assert_allclose(s_g.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-5)


def test_rerank_topk_ties_go_to_the_lower_page_position():
    """Equal scores (the same row at two ids, or one id twice) select the
    candidate at the lower page position, as jax.lax.top_k does."""
    V = torch.eye(4)
    V[3] = V[1]
    ids = torch.tensor([[3, 0, 1, 2], [2, 1, 1, 3]], dtype=torch.int32)
    Q = torch.stack([V[1], V[1]])
    got, _ = ops.rerank_topk(V, ids, Q, 1)
    want, _ = jops.rerank_topk(jnp.asarray(V.numpy()),
                               jnp.asarray(ids.numpy()),
                               jnp.asarray(Q.numpy()), k=1,
                               force_pallas=True)
    assert got[:, 0].tolist() == [3, 1] == np.asarray(want)[:, 0].tolist()
