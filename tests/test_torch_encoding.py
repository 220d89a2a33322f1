"""repro_torch encoders and filters against the JAX reference.

The same seeded numpy inputs go through both packages.  Codes and masks
are integer-exact; the arithmetic traps (round-half-away, division by the
interval width) are pinned at exact bucket edges and their neighbours.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import filtering as jflt
from repro_torch.core import encoding as tenc
from repro_torch.core import filtering as tflt


def _vectors(seed, d=300, n=48, unit=True):
    x = np.random.default_rng(seed).normal(size=(d, n)).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x


def _edge_values():
    """Bucket edges of P1/P2/I0.1/I0.2 and their float32 neighbours.  Zero's
    neighbours are left out: they are subnormal, and XLA on the CPU flushes
    subnormals to zero where PyTorch keeps them."""
    e = np.concatenate([np.arange(-100, 101) / 100.0,
                        np.arange(-20, 21) * 0.05]).astype(np.float32)
    e = e[e != 0]
    return np.concatenate([e, np.nextafter(e, np.float32(2)),
                           np.nextafter(e, np.float32(-2)),
                           np.float32([0.005, -0.005, 0.065, -0.065,
                                       0.0, -0.0])])


ENCODER_PAIRS = [
    (jenc.RoundingEncoder(2), tenc.RoundingEncoder(2)),
    (jenc.RoundingEncoder(1), tenc.RoundingEncoder(1)),
    (jenc.RoundingEncoder(3), tenc.RoundingEncoder(3)),
    (jenc.IntervalEncoder(0.1), tenc.IntervalEncoder(0.1)),
    (jenc.IntervalEncoder(0.2), tenc.IntervalEncoder(0.2)),
    (jenc.CombinedEncoder(jenc.RoundingEncoder(1), jenc.IntervalEncoder(0.1)),
     tenc.CombinedEncoder(tenc.RoundingEncoder(1),
                          tenc.IntervalEncoder(0.1))),
    (jenc.CombinedEncoder(), tenc.CombinedEncoder()),
]


@pytest.mark.parametrize("pair", ENCODER_PAIRS, ids=lambda p: p[0].scheme_id)
def test_encode_integer_exact(pair):
    je, te = pair
    for x in (_vectors(0), _edge_values()[None, :]):
        want = np.asarray(je.encode(jnp.asarray(x)))
        got = te.encode(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


@pytest.mark.parametrize("pair", ENCODER_PAIRS, ids=lambda p: p[0].scheme_id)
def test_encoder_metadata_matches(pair):
    je, te = pair
    assert te.scheme_id == je.scheme_id
    assert te.max_abs_bucket == je.max_abs_bucket
    assert te.n_columns(7) == je.n_columns(7)
    assert torch.empty(0, dtype=te.code_dtype).numpy().dtype == je.code_dtype
    assert dataclasses.asdict(te) == dataclasses.asdict(je)


@pytest.mark.parametrize("m", [0, 1, 127, 128, 32767, 32768, 10**6])
def test_smallest_int_dtype(m):
    got = torch.empty(0, dtype=tenc.smallest_int_dtype(m)).numpy().dtype
    assert got == jenc.smallest_int_dtype(m)


def test_paper_examples():
    w = torch.tensor([0.12, -0.13, 0.065])
    assert tenc.RoundingEncoder(2).encode(w).tolist() == [12, -13, 7]
    assert tenc.IntervalEncoder(0.1).encode(w).tolist() == [1, -2, 0]
    comb = tenc.CombinedEncoder(tenc.RoundingEncoder(3),
                                tenc.IntervalEncoder(0.2)).encode(w)
    assert comb.tolist() == [120, -130, 65, 0, -1, 0]


def test_combined_concat_layout():
    """The reference suite's layout test (tests/test_encoding.py): the
    rounding codes, then the interval codes, and the feature of every
    column."""
    enc = tenc.CombinedEncoder(tenc.RoundingEncoder(2),
                               tenc.IntervalEncoder(0.1))
    codes = enc.encode(torch.tensor([0.12, -0.13, 0.065]))
    assert codes.shape == (6,)
    assert codes[:3].tolist() == [12, -13, 7]
    assert codes[3:].tolist() == [1, -2, 0]
    assert enc.column_feature(3).tolist() == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("pair", ENCODER_PAIRS, ids=lambda p: p[0].scheme_id)
def test_column_feature_matches(pair):
    je, te = pair
    for n in (1, 7, 400):
        assert te.column_feature(n).tolist() == je.column_feature(n).tolist()


@pytest.mark.parametrize("pair", ENCODER_PAIRS, ids=lambda p: p[0].scheme_id)
def test_decode_center_bit_equal(pair):
    """Bucket centres of the same codes, bit-equal to the reference's
    (every code of the bucket range and the codes of encoded vectors);
    combined codes have no single centre in either package."""
    je, te = pair
    if isinstance(te, tenc.CombinedEncoder):
        with pytest.raises(NotImplementedError):
            te.decode_center(torch.zeros(3, dtype=te.code_dtype))
        return
    m = te.max_abs_bucket
    for codes in (np.arange(-m, m + 1),
                  te.encode(torch.from_numpy(_vectors(3))).numpy()):
        codes = codes.astype(je.code_dtype)
        want = np.asarray(je.decode_center(jnp.asarray(codes)))
        got = te.decode_center(torch.from_numpy(codes)).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("threshold", [0.05, 0.1, 0.2])
def test_trim_mask_exact(threshold):
    x = np.concatenate([_vectors(1), np.float32([[threshold] * 48])])
    want = np.asarray(jflt.TrimFilter(threshold).mask(jnp.asarray(x)))
    got = tflt.TrimFilter(threshold).mask(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m", [1, 5, 17, 48, 90])
def test_best_mask_exact_with_ties(m):
    x = _vectors(2, d=40, n=48)
    # ties in magnitude: best must drop the lowest-ranked extras exactly
    x[:10] = np.round(x[:10] * 4) / 4
    want = np.asarray(jflt.BestFilter(m).mask(jnp.asarray(x)))
    got = tflt.BestFilter(m).mask(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert (got.sum(-1) == min(m, 48)).all()


def test_feature_and_expand_mask_exact():
    x = _vectors(3, d=20, n=16)
    trim, best = (jflt.TrimFilter(0.1), jflt.BestFilter(6))
    want = np.asarray(jflt.expand_mask(
        jflt.feature_mask(jnp.asarray(x), trim=trim, best=best), 32))
    got = tflt.expand_mask(tflt.feature_mask(
        torch.from_numpy(x), trim=tflt.TrimFilter(0.1),
        best=tflt.BestFilter(6)), 32).numpy()
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tflt.expand_mask(torch.ones(3, 16, dtype=torch.bool), 24)


@pytest.mark.parametrize("m", [3, 10])
def test_index_best_codes_exact(m):
    x = _vectors(4, d=50, n=12)
    je = jenc.CombinedEncoder(jenc.RoundingEncoder(1), jenc.IntervalEncoder(0.1))
    te = tenc.CombinedEncoder(tenc.RoundingEncoder(1), tenc.IntervalEncoder(0.1))
    jc = je.encode(jnp.asarray(x))
    tc = te.encode(torch.from_numpy(x))
    want = np.asarray(jflt.index_best_codes(jnp.asarray(x), jc, m, 127))
    got = tflt.index_best_codes(torch.from_numpy(x), tc, m, 127).numpy()
    assert np.array_equal(got, want)
