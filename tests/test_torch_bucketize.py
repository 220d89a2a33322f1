"""repro_torch bucketize (fused normalize + quantize) against the JAX
package, on the CPU.

The reference suite's contract (``tests/test_kernels.py``): at least
99.99% of codes equal, and here also every other code exactly one bucket
away -- the norm is summed in another order, so a value on a bucket edge
may move.  Held against JAX's oracle ``bucketize_ref``, its Pallas kernel
in interpret mode (``ops._single(..., force_pallas=True)``), and, through
``ops.encode``, against ``encoder.encode(normalize(x))`` for all three
encoders.  On the CPU the wrapper runs the plain version; the CUDA kernel
is held to it by ``tests/test_torch_cuda.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core.rerank import normalize as jnormalize
from repro.kernels.bucketize import ops as jops
from repro.kernels.bucketize.ref import bucketize_ref as jax_bucketize_ref
from repro_torch.core import encoding as tenc
from repro_torch.core.rerank import normalize
from repro_torch.kernels.bucketize import ops, ref

DT = {np.int8: (torch.int8, jnp.int8), np.int16: (torch.int16, jnp.int16)}


def _assert_codes(got, want):
    """>= 99.99% equal, the rest one bucket off."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want)
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.9999
    assert (np.abs(got - want) <= 1).all()


@pytest.mark.parametrize("mode,param,dtype", [
    ("round", 100.0, np.int8), ("round", 1000.0, np.int16),
    ("floor", 0.1, np.int8), ("floor", 0.05, np.int8)])
@pytest.mark.parametrize("shape", [(16, 8), (255, 40), (256, 128)])
def test_modes_vs_jax(mode, param, dtype, shape):
    rng = np.random.default_rng(int(param) + sum(shape))
    X = rng.normal(size=shape).astype(np.float32)
    tdt, jdt = DT[dtype]
    got = ops.bucketize(torch.from_numpy(X), mode, param, tdt)
    assert got.dtype == tdt
    _assert_codes(got.numpy(),
                  jax_bucketize_ref(jnp.asarray(X), mode, param, jdt))
    _assert_codes(got.numpy(),
                  jops._single(jnp.asarray(X), mode, param, jdt, 64, True))


ENCODERS = [(tenc.RoundingEncoder(2), jenc.RoundingEncoder(2)),
            (tenc.IntervalEncoder(0.1), jenc.IntervalEncoder(0.1)),
            (tenc.CombinedEncoder(), jenc.CombinedEncoder()),
            (tenc.CombinedEncoder(tenc.RoundingEncoder(1),
                                  tenc.IntervalEncoder(0.1)),
             jenc.CombinedEncoder(jenc.RoundingEncoder(1),
                                  jenc.IntervalEncoder(0.1)))]


@pytest.mark.parametrize("tenc_,jenc_", ENCODERS,
                         ids=[e[0].scheme_id for e in ENCODERS])
def test_encode_matches_encoder_and_jax(tenc_, jenc_):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(100, 16)).astype(np.float32)
    got = ops.encode(torch.from_numpy(X), tenc_)
    assert got.dtype == tenc_.code_dtype
    _assert_codes(got.numpy(), tenc_.encode(normalize(torch.from_numpy(X))))
    _assert_codes(got.numpy(), jops.encode(jnp.asarray(X), jenc_,
                                           force_pallas=True))
    _assert_codes(got.numpy(), jenc_.encode(jnormalize(jnp.asarray(X))))


def test_ragged_rows_and_zero_rows():
    """Any row count, no padding; a zero row encodes to 0 in both modes."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(37, 23)).astype(np.float32)
    X[5] = 0.0
    for mode, param in (("round", 10.0), ("floor", 0.1)):
        got = ops.bucketize(torch.from_numpy(X), mode, param).numpy()
        assert got.shape == (37, 23) and (got[5] == 0).all()
        _assert_codes(got, jax_bucketize_ref(jnp.asarray(X), mode, param,
                                             jnp.int8))


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        ref.bucketize_ref(torch.zeros((2, 3)), "ceil", 0.1)
