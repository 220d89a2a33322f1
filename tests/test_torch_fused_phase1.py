"""repro_torch fused phase-1 (plain version and CUDA kernel) against JAX.

The fp32 contract: scores bit-equal everywhere, ids equal wherever the
score is finite, every id in range.  On the CPU the public wrapper runs the
plain version; the CUDA kernel's algorithm (bit-reversed tree per cell,
bitonic tile sort and merge, doc splits) is pinned here by a numpy
emulation, and the kernel itself by ``tests/test_torch_cuda.py`` on the
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_phase1 import ops as jops
from repro.kernels.fused_phase1 import ref as jref
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
    """The CUDA launcher never runs the plain version: a CPU tensor is an
    error there, raised before any build."""
    D, Q, W = _t(*_inputs(10, 1, 4, np.int8))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_phase1_cuda(D, Q, W, 5)


# ---------------------------------------------------- kernel emulation
def _bitrev(t, bits):
    return int(format(t, f"0{bits}b")[::-1], 2) if bits else 0


def _emu_cells(D, Q, W):
    """csrc cell_score for every cell: leaves in bit-reversed order,
    partial sums merged on a stack like a binary counter."""
    d, C = D.shape
    log = max(C - 1, 0).bit_length()
    stk = [None] * (log + 1)
    for t in range(1 << log):
        c = _bitrev(t, log)
        v = (np.where(Q[:, None, c] == D[None, :, c], W[:, None, c],
                      np.float32(0)) if c < C
             else np.zeros((Q.shape[0], d), np.float32))
        lvl = 0
        while (t >> lvl) & 1:
            v = stk[lvl] + v
            lvl += 1
        stk[lvl] = v
    return stk[log]


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
    """score_fold_kernel over `splits` doc splits, then merge_splits."""
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
    stride = tkernel._row_stride(C, itemsize)
    assert stride >= C and (stride * itemsize) % 4 == 0
    for c in (0, C - 1):
        banks = {((j * stride + c) * itemsize // 4) % 32 for j in range(32)}
        assert len(banks) == 32
