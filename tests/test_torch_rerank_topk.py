"""repro_torch phase-2 rerank kernel wrappers against the JAX package, on
the CPU.

Scores within the reference suite's rtol 1e-4 / atol 5e-5
(``tests/test_kernels.py``) of JAX's oracle and of its Pallas kernel in
interpret mode (``force_pallas=True``).  ``rerank_topk`` selects the ids
the JAX wrapper and the port's core ``rerank_topk`` select, ties to the
lower page position, and reports the core path's exact scores.  On the
CPU the wrappers run the plain versions; the CUDA kernels are held to them
by ``tests/test_torch_cuda.py`` on the card.

The launch plan (``kernel.launch_plan``) and the bulk body's arithmetic
are checked here: the work items cover every (q, p) once, the plan fits
the card's shared memory for every n it takes, picks the body by n % 4
and alignment, and raises past the largest n; a torch emulation that walks
the bulk body's tiles and sums in its order (``ref.lane_order_scores``,
with ``ref.fma32`` rounding as the card's ``fmaf``) is held to JAX.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core.rerank import normalize as jnormalize
from repro.kernels.rerank_topk import ops as jops
from repro.kernels.rerank_topk.ref import rerank_scores_ref as jax_ref
from repro_torch.core import rerank as trerank
from repro_torch.kernels.rerank_topk import kernel, ops, ref

# NVIDIA H100 SXM: opt-in shared memory a block, SMs, shared memory an SM
_H100 = (232448, 132, 233472)


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


@pytest.mark.parametrize("Q,P,n,sms", [
    (1, 1, 400, 132), (3, 17, 400, 132), (32, 320, 400, 132),
    (7, 1000, 400, 2), (5, 999, 4, 1), (4, 777, 4096, 3),
    (32, 8192, 400, 132), (9, 50, 8192, 5)])
def test_plan_work_items_cover_every_candidate_once(Q, P, n, sms):
    """Ragged P (not a multiple of the rows a stage) and more items than
    blocks (the ring wraps): every (q, p) in exactly one item, each block's
    items in query-major order, no item past the plan's rows."""
    plan = kernel.launch_plan(Q, P, n, True, _H100[0], sms, _H100[2])
    assert plan.body == "bulk" and plan.blocks <= 2 * sms
    seen = np.zeros((Q, P), np.int64)
    last = {}
    for b, q, p0, rows in kernel.work_items(plan, Q, P):
        assert 1 <= rows <= plan.rows and p0 % plan.rows == 0
        assert last.get(b, (-1, -1)) < (q, p0)
        last[b] = (q, p0)
        seen[q, p0:p0 + rows] += 1
    assert (seen == 1).all()
    assert len(last) == plan.blocks


def test_plan_fits_shared_memory_for_every_n():
    """n from 1 to 8192, aligned or not: the plan's dynamic shared memory
    fits a block's opt-in share, the bulk ring its blocks an SM together,
    with STAGES stages of 1 to MAX_ROWS rows."""
    optin, sms, per_sm = _H100
    for n in range(1, 8193):
        for aligned in (True, False):
            plan = kernel.launch_plan(32, 320, n, aligned, optin, sms,
                                      per_sm)
            assert 0 < plan.smem <= optin
            assert plan.body == ("bulk" if aligned and n % 4 == 0
                                 else "simple")
            if plan.body == "bulk":
                assert plan.stages == kernel.STAGES
                assert 1 <= plan.rows <= kernel.MAX_ROWS
                assert plan.smem == kernel.bulk_smem_bytes(n, plan.rows,
                                                           plan.stages)
                per_block = plan.blocks // sms
                assert per_block in (1, 2)
                assert per_block * (plan.smem + 1024) <= per_sm
            else:
                assert plan.smem == 4 * n


@pytest.mark.parametrize("optin", [232448, 166912, 49152])
def test_plan_raises_past_the_largest_n(optin):
    """The simple body takes n up to optin // 4 floats; past that the plan
    raises and names that n."""
    largest = optin // 4
    assert kernel.launch_plan(2, 9, largest, True, optin, 132).smem <= optin
    with pytest.raises(ValueError, match=f"largest n is {largest}"):
        kernel.launch_plan(2, 9, largest + 1, True, optin, 132)


@pytest.mark.parametrize("n,aligned,body", [
    (400, True, "bulk"), (400, False, "simple"), (4, True, "bulk"),
    (4096, True, "bulk"), (8192, True, "bulk"), (14524, True, "bulk"),
    (14528, True, "simple"), (37, True, "simple"), (401, True, "simple"),
    (1, True, "simple"), (402, True, "simple")])
def test_plan_chooses_the_body_by_shape_and_alignment(n, aligned, body):
    plan = kernel.launch_plan(32, 320, n, aligned, *_H100)
    assert plan.body == body
    assert kernel.launch_plan(32, 320, n, aligned, *_H100,
                              body="simple").body == "simple"
    if body == "bulk":
        assert kernel.launch_plan(32, 320, n, aligned, *_H100,
                                  body="bulk") == plan
    else:
        with pytest.raises(ValueError, match="bulk body"):
            kernel.launch_plan(32, 320, n, aligned, *_H100, body="bulk")


def _round_f32(x: Fraction) -> float:
    """The float32 nearest to ``x``, ties to even, from exact arithmetic."""
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return float(min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                           int(c.view(np.int32)) & 1)))


def test_fma32_rounds_once():
    """fma32 is fmaf: the exact a*b + c rounded once to float32, also where
    rounding the float64 sum first would land on a float32 midpoint."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=4000).astype(np.float32)
    b = (rng.normal(size=4000) * 2.0 ** rng.integers(-30, 30, 4000)
         ).astype(np.float32)
    c = rng.normal(size=4000).astype(np.float32)
    # (2^-12 (1 + 2^-18)) (2^-12 (1 - 2^-18)) + (1 + 2^-23): the float64 sum
    # rounds to the midpoint 1 + 2^-23 + 2^-24, the exact one lies below it
    a[0], b[0], c[0] = 2.0 ** -12 * (1 + 2.0 ** -18), \
        2.0 ** -12 * (1 - 2.0 ** -18), 1 + 2.0 ** -23
    got = ref.fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want, np.float32))
    assert got[0] == np.float32(1 + 2.0 ** -23)
    assert np.float32(np.float64(a[0]) * b[0] + c[0]) != got[0]


@pytest.mark.parametrize("d,Q,P,n,sms", [
    (300, 3, 40, 400, 2), (1000, 5, 999, 4, 1), (64, 2, 17, 64, 1),
    (500, 4, 33, 4096, 3), (50, 3, 21, 8, 132)])
def test_bulk_emulation_vs_jax(d, Q, P, n, sms):
    """The bulk body in torch -- its plan's tiles walked block by block,
    each stage's rows summed in lane order with the shuffle tree, ids
    clamped -- within rtol 1e-4 / atol 5e-5 of JAX's oracle, of its Pallas
    kernel in interpret mode and of the plain version."""
    rng = np.random.default_rng(d + P + n)
    V = rng.normal(size=(d, n)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    ids = rng.integers(-5, d + 5, size=(Q, P)).astype(np.int32)
    QV = rng.normal(size=(Q, n)).astype(np.float32)
    QV /= np.linalg.norm(QV, axis=1, keepdims=True)
    Vt, idt, Qt = map(torch.from_numpy, (V, ids, QV))
    plan = kernel.launch_plan(Q, P, n, True, _H100[0], sms, _H100[2])
    assert plan.body == "bulk"
    got = torch.full((Q, P), float("nan"))
    for _, q, p0, rows in kernel.work_items(plan, Q, P):
        got[q, p0:p0 + rows] = ref.lane_order_scores(
            Vt, idt[q:q + 1, p0:p0 + rows], Qt[q:q + 1])[0]
    cand = V[np.clip(ids, 0, d - 1)]
    for want in (jax_ref(jnp.asarray(cand), jnp.asarray(QV)),
                 jops.rerank_scores(jnp.asarray(cand), jnp.asarray(QV),
                                    force_pallas=True),
                 ref.candidate_scores_ref(Vt, idt.clamp(0, d - 1), Qt)):
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-5)
    assert torch.equal(got, ref.lane_order_scores(Vt, idt, Qt))


@pytest.mark.parametrize("d,Q,P,n", [(200, 3, 50, 37), (64, 1, 1, 1),
                                     (100, 2, 70, 401)])
def test_simple_body_scalar_order_vs_jax(d, Q, P, n):
    """The simple body's float-a-lane order (n % 4 != 0 or a table off
    16-byte alignment) within the same tolerance of JAX's oracle."""
    rng = np.random.default_rng(n)
    V = rng.normal(size=(d, n)).astype(np.float32)
    ids = rng.integers(0, d, size=(Q, P)).astype(np.int32)
    QV = rng.normal(size=(Q, n)).astype(np.float32)
    got = ref.lane_order_scores(*map(torch.from_numpy, (V, ids, QV)),
                                vec=False)
    want = jax_ref(jnp.asarray(V[ids]), jnp.asarray(QV))
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-5)
    with pytest.raises(ValueError, match="n % 4"):
        ref.lane_order_scores(*map(torch.from_numpy, (V, ids, QV)))
