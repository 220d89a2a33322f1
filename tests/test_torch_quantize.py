"""repro_torch int8 quantization against the JAX reference.

The table (codes, scale, zero) is bit-equal to ``quantize_rows``, at
mixed row scales and for degenerate rows; ``quantized_scores`` agrees to
rtol/atol 1e-4 (a float32 product reduces in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import VectorIndex as JIndex
from repro.core import quantize as jq
from repro_torch import interop
from repro_torch.core import VectorIndex
from repro_torch.core import encoding as tenc
from repro_torch.core import quantize as tq


def _rows(seed, d, n, lo=0.05, hi=5.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d, n)).astype(np.float32)
            * rng.uniform(lo, hi, size=(d, 1)).astype(np.float32))


def _assert_bits(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("d,n,seed", [(4000, 400, 0), (257, 33, 1),
                                      (64, 1, 2), (500, 48, 3)])
def test_quantize_rows_bit_equal(d, n, seed):
    V = _rows(seed, d, n)
    _assert_bits(tq.quantize_rows(torch.from_numpy(V)),
                 jq.quantize_rows(jnp.asarray(V)))


def test_degenerate_rows_bit_equal_and_exact():
    """All-zero rows (padding) -> codes 0, zero 0; constant rows -> codes
    0 and the constant back exactly -- the same bits as JAX."""
    V = np.concatenate([np.zeros((3, 8), np.float32),
                        np.full((2, 8), 1.75, np.float32),
                        np.full((1, 8), -3e-9, np.float32)])
    got = tq.quantize_rows(torch.from_numpy(V))
    _assert_bits(got, jq.quantize_rows(jnp.asarray(V)))
    assert not got[0].any()
    assert np.array_equal(tq.dequantize_rows(*got)[:5].numpy(), V[:5])


def test_round_trip_error_bound():
    V = _rows(4, 200, 48)
    codes, scale, zero = tq.quantize_rows(torch.from_numpy(V))
    err = np.abs(tq.dequantize_rows(codes, scale, zero).numpy() - V)
    assert (err <= scale.numpy()[:, None] / 2 * (1 + 1e-5) + 1e-7).all()
    assert (codes.abs().amax(dim=1) == tq.QMAX).all()


def test_subbatch_determinism_and_blocked_table(monkeypatch):
    """Any sub-batch of rows quantizes to the bits it gets inside the
    table, so quantize_table's row blocks cannot move a bit."""
    V = torch.from_numpy(_rows(5, 64, 16))
    c_all, s_all, z_all = tq.quantize_rows(V)
    for lo, hi in [(0, 1), (7, 30), (30, 64)]:
        c, s, z = tq.quantize_rows(V[lo:hi])
        assert torch.equal(c, c_all[lo:hi]) and torch.equal(s, s_all[lo:hi])
        assert torch.equal(z, z_all[lo:hi])
    monkeypatch.setattr(tq, "_ROWS", 7)
    qt = tq.quantize_table(V)
    assert torch.equal(qt.codes, c_all) and torch.equal(qt.scale, s_all)
    assert torch.equal(qt.zero, z_all)


@pytest.mark.parametrize("q", [1, 9])
def test_quantized_scores_close(q):
    V = _rows(6, 300, 40)
    Q = np.random.default_rng(7).normal(size=(q, 40)).astype(np.float32)
    codes, scale, zero = (np.array(a) for a in
                          jq.quantize_rows(jnp.asarray(V)))
    want = np.asarray(jq.quantized_scores(
        *[jnp.asarray(a) for a in (codes, scale, zero, Q)]))
    got = tq.quantized_scores(*[torch.from_numpy(a)
                                for a in (codes, scale, zero, Q)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the factored form is the dot against the dequantized rows
    deq = tq.dequantize_rows(*[torch.from_numpy(a)
                               for a in (codes, scale, zero)])
    np.testing.assert_allclose(got.numpy(), Q @ deq.numpy().T, rtol=1e-4,
                               atol=1e-4)


def test_table_cached_per_instance_and_equal_to_jax():
    """The lazy table is derived once per index, and an index carried
    across from JAX derives the very bits JAX's index derives."""
    V = _rows(8, 150, 24, 0.5, 2.0)
    jidx = JIndex.build(jnp.asarray(V))
    tidx = interop.index_from_numpy(
        np.asarray(jidx.vectors), np.asarray(jidx.codes),
        np.asarray(jidx.postings.post_docs),
        np.asarray(jidx.postings.post_codes), tenc.RoundingEncoder(2),
        device="cpu")
    qt = tidx.quantized
    assert tidx.quantized is qt
    assert qt.nbytes_codes == 150 * 24
    jt = jidx.quantized
    _assert_bits((qt.codes, qt.scale, qt.zero), (jt.codes, jt.scale, jt.zero))
    other = VectorIndex.build(V, device="cpu")
    assert other.quantized is not qt
