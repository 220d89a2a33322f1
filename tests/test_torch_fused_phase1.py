"""repro_torch fused phase-1 (plain versions and CUDA kernels) against JAX.

The fp32 contract: scores bit-equal everywhere, ids equal wherever the
score is finite, every id in range.  The int8 contract
(``fused_phase1_quant``) is the reference suite's ``_assert_quant_parity``:
scores within rtol 1e-5 and atol 1e-4, ids equal wherever the reference
separates neighbours by more than 1e-4, every id in range.  On the CPU the public wrapper runs the
plain version; the CUDA kernel's algorithm (the tree per cell in its
evaluation order, ``ref.match_scores_words``; bitonic tile sort and
merge; doc splits) is pinned here by an emulation, and the kernel itself
by ``tests/test_torch_cuda.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jquant
from repro.kernels.fused_phase1 import ops as jops
from repro.kernels.fused_phase1 import ref as jref
from repro_torch.core import quantize as tquant
from repro_torch.kernels import _build
from repro_torch.kernels.fused_phase1 import kernel as tkernel
from repro_torch.kernels.fused_phase1 import ops as tops
from repro_torch.kernels.fused_phase1 import ref as tref

# the shapes of the reference's own kernel suite, plus C = 23, where a
# jnp.sum scorer once diverged in the last ulp (at d = 5001 there; the
# card's test runs that d)
SHAPES = [(64, 1, 8, 16), (700, 5, 37, 17), (513, 8, 48, 33),
          (100, 1, 1, 10), (1000, 9, 20, 320), (3000, 9, 23, 33)]


def _inputs(d, q, c, dtype, lo=-50, hi=50, seed=None):
    rng = np.random.default_rng(d + q + c if seed is None else seed)
    D = rng.integers(lo, hi, size=(d, c)).astype(dtype)
    Q = rng.integers(lo, hi, size=(q, c)).astype(dtype)
    W = rng.random((q, c)).astype(np.float32)
    return D, Q, W


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _assert_parity(got, want, d):
    s_g, i_g = (np.asarray(x) for x in got)
    s_w, i_w = (np.asarray(x) for x in want)
    assert s_g.dtype == np.float32 and i_g.dtype == np.int32
    assert np.array_equal(s_g, s_w)
    fin = np.isfinite(s_w)
    assert np.array_equal(i_g[fin], i_w[fin])
    assert (i_g >= 0).all() and (i_g < d).all()


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("shape", SHAPES)
def test_match_scores_bit_equal(shape, dtype):
    d, q, c, _ = shape
    D, Q, W = _inputs(d, q, c, dtype)
    want = np.asarray(jref.match_scores(*map(jnp.asarray, (D, Q, W))))
    got = tref.match_scores(*_t(D, Q, W)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("C", [1, 2, 3, 12, 23, 37, 96, 400, 401, 800])
def test_match_scores_words_bit_equal(C, dtype):
    """The CUDA scorer's evaluation order (interleaved subtrees per 32-bit
    word, blocks of bit-reversed words, zero-weight padding to whole
    4-column groups) is bit-equal to JAX's match_scores, with weights
    spread over six decades so that another order of adds shows."""
    rng = np.random.default_rng(C)
    d, q = 48, 3
    D = rng.integers(-2, 2, size=(d, C)).astype(dtype)
    Q = rng.integers(-2, 2, size=(q, C)).astype(dtype)
    W = (rng.random((q, C)) * 10 ** rng.uniform(-3, 3, (q, C))).astype(
        np.float32)
    want = np.asarray(jref.match_scores(*map(jnp.asarray, (D, Q, W))))
    got = tref.match_scores_words(*_t(D, Q, W)).numpy()
    assert got.dtype == np.float32 and got.shape == (q, d)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_phase1_plain_vs_jax(shape, dtype):
    """The port's wrapper on the CPU against the JAX composed oracle and
    the JAX public wrapper (Pallas interpret or its stream fold)."""
    d, q, c, page = shape
    D, Q, W = _inputs(d, q, c, dtype)
    jargs = [jnp.asarray(a) for a in (D, Q, W)]
    before = tops.launches
    got = tops.fused_phase1(*_t(D, Q, W), page=page)
    assert tops.launches == before          # the CPU path launches nothing
    _assert_parity(got, jref.fused_phase1_ref(*jargs, page=page), d)
    _assert_parity(got, jops.fused_phase1(*jargs, page=page), d)
    _assert_parity(tref.fused_phase1_ref(*_t(D, Q, W), page=page),
                   jref.fused_phase1_ref(*jargs, page=page), d)


@pytest.mark.parametrize("force", [False, True])
def test_live_mask_and_inf_slots(force):
    """Fewer live docs than page: the finite prefix is the live docs'
    ranking, the rest -inf with in-range ids."""
    d, q, c, page = 60, 3, 12, 32
    D, Q, W = _inputs(d, q, c, np.int8, lo=-20, hi=20, seed=0)
    live = np.random.default_rng(0).random(d) < 0.3
    n_live = int(live.sum())
    assert 0 < n_live < page
    jargs = [jnp.asarray(a) for a in (D, Q, W)]
    want = jops.fused_phase1(*jargs, page=page, live=jnp.asarray(live),
                             force_pallas=force)
    got = tops.fused_phase1(*_t(D, Q, W), page=page,
                            live=torch.from_numpy(live))
    _assert_parity(got, want, d)
    s = got[0].numpy()
    assert (np.isfinite(s).sum(axis=1) == n_live).all()
    assert live[got[1].numpy()[np.isfinite(s)]].all()


def test_page_clamps_to_doc_count():
    D, Q, W = _inputs(20, 2, 6, np.int8, lo=-3, hi=3)
    s, i = tops.fused_phase1(*_t(D, Q, W), page=64)
    assert s.shape == i.shape == (2, 20)
    _assert_parity((s, i), jref.fused_phase1_ref(
        *map(jnp.asarray, (D, Q, W)), page=20), 20)


@pytest.mark.parametrize("block", [1, 7, 64, 512, 4096])
def test_stream_block_invariance(block):
    """The plain fold's doc tile can never move a bit (heavy ties)."""
    D, Q, W = _inputs(300, 4, 64, np.int8, lo=-3, hi=3, seed=1)
    want = tref.fused_phase1_ref(*_t(D, Q, W), page=33)
    got = tref.fused_phase1_stream(*_t(D, Q, W), page=33, block=block)
    _assert_parity(got, want, 300)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA launchers never run the plain versions: a CPU tensor is an
    error there, raised before any build."""
    D, Q, W = _t(*_inputs(10, 1, 4, np.int8))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_phase1_cuda(D, Q, W, 5)
    codes, scale, zero = tquant.quantize_rows(torch.randn(10, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_phase1_quant_cuda(codes, scale, zero,
                                        torch.randn(2, 4), 5)


# ------------------------------------------------------------ int8 fold
def _assert_quant_parity(got, want, d, tol=1e-4):
    s_g, i_g = (np.asarray(x) for x in got)
    s_w, i_w = (np.asarray(x) for x in want)
    assert s_g.dtype == np.float32 and i_g.dtype == np.int32
    fin = np.isfinite(s_w)
    assert np.array_equal(fin, np.isfinite(s_g))
    np.testing.assert_allclose(s_g[fin], s_w[fin], rtol=1e-5, atol=tol)
    sep = fin.copy()
    if s_w.shape[1] > 1:
        with np.errstate(invalid="ignore"):   # -inf slots: nan gap, no tie
            tie = np.abs(s_w[:, :-1] - s_w[:, 1:]) <= tol
        sep[:, 1:] &= ~tie
        sep[:, :-1] &= ~tie
    assert np.array_equal(i_g[sep], i_w[sep])
    assert (i_g >= 0).all() and (i_g < d).all()


def _quant_inputs(d, n, q, seed):
    """The reference suite's inputs: rows at mixed scales, quantized by
    JAX; the port gets the very same table."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(d, n)).astype(np.float32) * \
        rng.uniform(0.1, 4.0, size=(d, 1)).astype(np.float32)
    codes, scale, zero = (np.array(a) for a in
                          jquant.quantize_rows(jnp.asarray(V)))
    Q = rng.normal(size=(q, n)).astype(np.float32)
    return codes, scale, zero, Q, rng


QUANT_SHAPES = [(64, 8, 1, 16), (300, 16, 4, 33), (513, 32, 8, 64),
                (100, 1, 2, 10), (2000, 24, 9, 320)]


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_fused_phase1_quant_vs_jax(shape):
    """The port's int8 wrapper (streamed fold), its composed reference and
    the JAX wrapper (Pallas interpret) against the JAX composed oracle."""
    d, n, q, page = shape
    codes, scale, zero, Q, _ = _quant_inputs(d, n, q, sum(shape))
    jargs = [jnp.asarray(a) for a in (codes, scale, zero, Q)]
    want = jref.fused_phase1_quant_ref(*jargs, page=page)
    before = tops.quant_launches
    got = tops.fused_phase1_quant(*_t(codes, scale, zero, Q), page=page)
    assert tops.quant_launches == before    # the CPU path launches nothing
    _assert_quant_parity(got, want, d)
    _assert_quant_parity(tref.fused_phase1_quant_ref(
        *_t(codes, scale, zero, Q), page=page), want, d)
    _assert_quant_parity(got, jops.fused_phase1_quant(
        *jargs, page=page, force_pallas=True), d)


@pytest.mark.parametrize("force", [False, True])
def test_fused_phase1_quant_live_mask(force):
    """Fewer live docs than page: the finite prefix is the live docs'
    ranking, the rest -inf with in-range ids."""
    d, n, q, page = 90, 12, 3, 48
    codes, scale, zero, Q, rng = _quant_inputs(d, n, q, 4)
    live = rng.random(d) < 0.3
    n_live = int(live.sum())
    assert 0 < n_live < page
    want = jops.fused_phase1_quant(
        *[jnp.asarray(a) for a in (codes, scale, zero, Q)], page=page,
        live=jnp.asarray(live), force_pallas=force)
    got = tops.fused_phase1_quant(*_t(codes, scale, zero, Q), page=page,
                                  live=torch.from_numpy(live))
    _assert_quant_parity(got, want, d)
    s = got[0].numpy()
    assert (np.isfinite(s).sum(axis=1) == n_live).all()
    assert live[got[1].numpy()[np.isfinite(s)]].all()


@pytest.mark.parametrize("block", [1, 7, 64, 512, 4096])
def test_quant_stream_block_invariance(block):
    """The int8 plain fold agrees with its composed reference for any doc
    tile (the product's reduction order may differ per tile width)."""
    codes, scale, zero, Q, _ = _quant_inputs(300, 16, 4, 9)
    args = _t(codes, scale, zero, Q)
    want = tref.fused_phase1_quant_ref(*args, page=33)
    got = tref.fused_phase1_quant_stream(*args, page=33, block=block)
    _assert_quant_parity(got, want, 300)


# ---------------------------------------------------- kernel emulation
def _emu_cells(D, Q, W):
    """csrc cell_score for every cell, in its evaluation order."""
    return tref.match_scores_words(*_t(D, Q, W)).numpy()


def _before(sa, ia, sb, ib):
    return (sa > sb) | ((sa == sb) & (ia < ib))


def _cas(s, i, a, b, swap):
    sa, sb, ia, ib = s[:, a], s[:, b], i[:, a], i[:, b]
    s[:, a], s[:, b] = np.where(swap, sb, sa), np.where(swap, sa, sb)
    i[:, a], i[:, b] = np.where(swap, ib, ia), np.where(swap, ia, ib)


def _pairs(n, j):
    p = np.arange(n // 2)
    a = 2 * j * (p // j) + p % j
    return a, a + j


def _emu_sort(s, i):
    n, k = s.shape[1], 2
    while k <= n:
        j = k >> 1
        while j:
            a, b = _pairs(n, j)
            up = (a & k) == 0
            _cas(s, i, a, b, np.where(up, _before(s[:, b], i[:, b], s[:, a],
                                                  i[:, a]),
                                      _before(s[:, a], i[:, a], s[:, b],
                                              i[:, b])))
            j >>= 1
        k <<= 1


def _emu_merge(acc_s, acc_i, src_s, src_i):
    n = acc_s.shape[1]
    bs, bi = src_s[:, :n][:, ::-1], src_i[:, :n][:, ::-1]
    take = _before(bs, bi, acc_s, acc_i)
    acc_s[:] = np.where(take, bs, acc_s)
    acc_i[:] = np.where(take, bi, acc_i)
    j = n // 2
    while j:
        a, b = _pairs(n, j)
        _cas(acc_s, acc_i, a, b,
             _before(acc_s[:, b], acc_i[:, b], acc_s[:, a], acc_i[:, a]))
        j >>= 1


def _emu_kernel(D, Q, W, page, live, splits, tile):
    """score_fold_kernel over `splits` doc splits (each tile's entrants
    compacted, sorted and merged), then merge_splits."""
    d = D.shape[0]
    pp = 1 << max(page - 1, 0).bit_length()
    tile = max(tile, pp)
    n_tiles = -(-d // tile)
    chunk = -(-n_tiles // max(1, min(n_tiles, splits))) * tile
    S = _emu_cells(D, Q, W)
    parts = []
    for lo in range(0, d, chunk):
        hi = min(lo + chunk, d)
        acc_s = np.full((Q.shape[0], pp), -np.inf, np.float32)
        acc_i = np.zeros((Q.shape[0], pp), np.int64)
        for base in range(lo, hi, tile):
            doc = base + np.arange(tile)
            ok = doc < hi
            ok &= live[np.minimum(doc, d - 1)] if live is not None else ok
            ts = np.where(ok, S[:, np.minimum(doc, d - 1)], -np.inf).astype(
                np.float32)
            ti = np.broadcast_to(doc, ts.shape).copy()
            # only entries ahead of the accumulator's last can enter: those
            # move to the front, the rest become (-inf, INT_MAX) padding
            keep = _before(ts, ti, acc_s[:, -1:], acc_i[:, -1:])
            if not keep.any():
                continue
            order = np.argsort(~keep, axis=1, kind="stable")
            ts = np.where(np.take_along_axis(keep, order, 1),
                          np.take_along_axis(ts, order, 1),
                          np.float32(-np.inf)).astype(np.float32)
            ti = np.where(np.take_along_axis(keep, order, 1),
                          np.take_along_axis(ti, order, 1), 2**31 - 1)
            _emu_sort(ts, ti)
            _emu_merge(acc_s, acc_i, ts, ti)
        parts.append((acc_s, acc_i))
    out_s, out_i = parts[0]
    for ps, pi in parts[1:]:
        _emu_merge(out_s, out_i, ps, pi)
    return out_s[:, :page], np.minimum(out_i[:, :page], d - 1).astype(np.int32)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("shape", [(700, 5, 37, 17), (513, 8, 48, 33),
                                   (100, 1, 1, 10), (1000, 3, 20, 320)])
def test_kernel_algorithm_emulation(shape, splits):
    """The CUDA kernel's algorithm, emulated in numpy at small tiles with
    heavy ties, is bit-equal to the composed reference for any split."""
    d, q, c, page = shape
    D, Q, W = _inputs(d, q, c, np.int8, lo=-4, hi=4)
    live = np.random.default_rng(d).random(d) < 0.7
    for lv in (None, live):
        want = jref.fused_phase1_ref(*map(jnp.asarray, (D, Q, W)), page=page,
                                     live=None if lv is None
                                     else jnp.asarray(lv))
        got = _emu_kernel(D, Q, W, page, lv, splits, tile=32)
        _assert_parity(got, want, d)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 3, 23, 37, 400, 800])
def test_staged_row_stride_is_bank_conflict_free(C, itemsize):
    """The kernel stages code rows at this stride: the 32 rows a warp
    reads at one column must sit in 32 different 4-byte banks."""
    stride = _build.row_stride(C, itemsize)
    assert stride >= C and (stride * itemsize) % 4 == 0
    for c in (0, C - 1):
        banks = {((j * stride + c) * itemsize // 4) % 32 for j in range(32)}
        assert len(banks) == 32


class _H100:
    """The properties of an H100 that the launch plan reads."""

    multi_processor_count = 132
    shared_memory_per_block_optin = 232448


def _fold_smem(C, itemsize, qb_per_query):
    """topk_fold.cuh's fold_layout bytes: accumulator and tile (none when
    spilled), counts, the scorer's queries, the staged rows."""
    def a16(x):
        return -(-x // 16) * 16

    def smem(bq, page, tile, sub, stride, spill):
        pp = 1 << max(page - 1, 0).bit_length()
        acc, til = (0, 0) if spill else (bq * pp * 4, bq * tile * 4)
        return (2 * a16(acc) + 2 * a16(til) + a16(bq * 4) + a16(bq * C * 4)
                + a16(bq * qb_per_query) + a16(sub * stride * itemsize))
    return smem


def _quant_smem(n):
    """fused_phase1_quant.cu's bytes (topk_fold.cuh's fold_layout with the
    tile scorer): accumulator and tile (none when spilled), counts, the
    three query pieces of 8 rows at padded_k(n) + 16 bytes, 8 scales and
    8 sums, and two staging buffers of sub x stride bytes plus 64, plus
    the sub-block's scales and zeros."""
    def a16(x):
        return -(-x // 16) * 16

    kp = -(-n // 32) * 32

    def smem(bq, page, tile, sub, stride, spill):
        pp = 1 << max(page - 1, 0).bit_length()
        acc, til = (0, 0) if spill else (bq * pp * 4, bq * tile * 4)
        return (2 * a16(acc) + 2 * a16(til) + a16(bq * 4)
                + a16(3 * 8 * (kp + 16)) + a16(64)
                + a16(2 * (a16(sub * stride) + 64 + 8 * sub)))
    return smem


@pytest.mark.parametrize("scorer", ["fused_phase1", "fused_phase1_quant"])
@pytest.mark.parametrize("d,Q,page", [
    (4_181_504, 32, 320), (65_536, 8, 8192), (65_536, 8, 16_384),
    (4_181_504, 32, 16_384), (300_000, 3, 200_000), (16_385, 1, 16_385)])
def test_fold_plan_answers_any_page(scorer, d, Q, page):
    """With an H100's properties, every page gets a plan: the accumulator
    and tile in shared memory up to next_pow2(page) = 8192, in the device
    workspace past it, with the doc splits cut so that the workspace stays
    under WORKSPACE_BYTES (one split at least); the splits cover d."""
    C = 400
    if scorer == "fused_phase1":
        smem = _fold_smem(C, 1, C)
        plan = tkernel._fold_plan(smem, d, Q, C, 1, page, _H100())
    else:
        smem = _quant_smem(C)
        plan = tkernel._quant_plan(smem, d, Q, C, page, _H100())
    pp = 1 << (page - 1).bit_length()
    assert plan.spill == (pp > 8192)
    assert plan.merge_spill == (8 * pp > _H100.shared_memory_per_block_optin)
    assert plan.tile >= pp and plan.chunk % plan.tile == 0
    assert (plan.splits - 1) * plan.chunk < d <= plan.splits * plan.chunk
    assert 1 <= plan.block_q <= min(8, Q)
    assert smem(plan.block_q, page, plan.tile, plan.sub, plan.stride,
                int(plan.spill)) <= _H100.shared_memory_per_block_optin
    if plan.spill:
        ws = (-(-Q // plan.block_q) * plan.splits
              * tkernel._fold_ws_bytes(plan.block_q, pp, plan.tile))
        assert plan.splits == 1 or ws <= tkernel.WORKSPACE_BYTES


@pytest.mark.parametrize("sources", [
    tkernel._SOURCES, tkernel._QUANT_SOURCES,
    __import__("repro_torch.kernels.code_match.kernel",
               fromlist=["_SOURCES"])._SOURCES,
    __import__("repro_torch.kernels.bucketize.kernel",
               fromlist=["_SOURCES"])._SOURCES,
    __import__("repro_torch.kernels.rerank_topk.kernel",
               fromlist=["_SOURCES"])._SOURCES,
    __import__("repro_torch.kernels.postings_walk.kernel",
               fromlist=["_SOURCES"])._SOURCES],
    ids=["fused_phase1", "fused_phase1_quant", "code_match", "bucketize",
         "rerank_topk", "postings_walk"])
def test_library_sources_name_every_included_header(sources):
    """A library is cached under the hash of its sources, so every header
    its .cu files include (directly or through another header) must be
    among them: else an edit to the header would reuse a stale build."""
    import re

    listed = {p.resolve() for p in sources}
    todo = [p for p in sources if p.suffix == ".cu"]
    assert todo
    while todo:
        src = todo.pop()
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            dep = (src.parent / inc).resolve()
            assert dep in listed, f"{src.name} includes {inc}, not listed"
            todo.append(dep)
