"""repro_torch posting tables against the JAX reference.

Posting tables, ranges and document frequencies are integer-exact; idf
weights agree to rtol 1e-6 (``log1p`` may differ by an ulp between the
frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import postings as jpost
from repro_torch.core import postings as tpost


def _codes(seed, d, C, lo, hi, dtype):
    return np.random.default_rng(seed).integers(lo, hi, size=(d, C)).astype(
        dtype)


# C = 70 spans three column blocks of the blocked sort
@pytest.mark.parametrize("d,C,dtype", [(257, 5, np.int8), (1000, 70, np.int8),
                                       (333, 33, np.int16),
                                       (64, 3, np.int32)])
def test_build_postings_exact(d, C, dtype):
    codes = _codes(d + C, d, C, -6, 6, dtype)
    want = jpost.build_postings(jnp.asarray(codes))
    got = tpost.build_postings(torch.from_numpy(codes))
    assert got.n_docs == want.n_docs == d
    assert got.post_docs.dtype == torch.int32
    assert got.post_codes.dtype == torch.from_numpy(codes).dtype
    assert np.array_equal(got.post_docs.numpy(), np.asarray(want.post_docs))
    assert np.array_equal(got.post_codes.numpy(), np.asarray(want.post_codes))


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_lookup_and_df_exact(dtype):
    codes = _codes(1, 500, 40, -8, 8, dtype)
    # query codes inside, at and beyond the table's range (df 0 tokens)
    qcodes = _codes(2, 9, 40, -10, 10, dtype)
    jp = jpost.build_postings(jnp.asarray(codes))
    tp = tpost.build_postings(torch.from_numpy(codes))
    lo_w, hi_w = jax.vmap(lambda q: jpost.lookup(jp, q))(jnp.asarray(qcodes))
    lo_g, hi_g = tpost.lookup(tp, torch.from_numpy(qcodes))
    assert np.array_equal(lo_g.numpy(), np.asarray(lo_w))
    assert np.array_equal(hi_g.numpy(), np.asarray(hi_w))
    one_lo, one_hi = tpost.lookup(tp, torch.from_numpy(qcodes[3]))
    assert np.array_equal(one_lo.numpy(), np.asarray(lo_w)[3])
    assert np.array_equal(one_hi.numpy(), np.asarray(hi_w)[3])
    df_w = np.asarray(jpost.df_lookup(jp, jnp.asarray(qcodes)))
    df_g = tpost.df_lookup(tp, torch.from_numpy(qcodes))
    assert df_g.dtype == torch.int32
    assert np.array_equal(df_g.numpy(), df_w)
    # df is the plain equality count against the code matrix
    assert np.array_equal(
        df_w, (qcodes[:, None, :] == codes[None, :, :]).sum(1))


def test_idf_weights_close():
    df = np.random.default_rng(3).integers(0, 5000, size=(9, 64)).astype(
        np.int32)
    for n_docs in (5000, 4_181_504):
        want = np.asarray(jpost.idf_weights(jnp.asarray(df), n_docs))
        got = tpost.idf_weights(torch.from_numpy(df), n_docs)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
