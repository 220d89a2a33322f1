"""repro_torch's gradient compression against the JAX package's, on the CPU.

The reference's ``TestCompression`` cases (tests/test_train.py), ported,
each also holding the port to ``repro.train.compression`` on the same
seeded inputs, and:

* ``topk_compress`` picks ties in magnitude at the lower flat index, as
  ``jax.lax.top_k`` does: the same indices and values;
* ``int8_quantize`` is bit-equal to the reference's (payload and scale),
  halves rounded to even;
* ``compressed_psum`` over a sequence of participants equals the sum the
  reference's psum forms, composed from its ``int8_quantize``: int32 sum
  of the payloads times the mean of the scales (bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_allclose

from repro.train import compression as jc
from repro_torch.train import compression as tc


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_ef_topk_conserves_mass():
    g = np.random.default_rng(0).normal(size=(128,)).astype(np.float32)
    sparse, err2 = tc.ef_topk_step(_t(g), torch.zeros(128), ratio=0.1)
    assert_allclose((sparse + err2).numpy(), g, rtol=1e-6)
    assert int((sparse != 0).sum()) <= 13
    js, je = jc.ef_topk_step(jnp.asarray(g), jnp.zeros(128), ratio=0.1)
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(js))
    np.testing.assert_array_equal(err2.numpy(), np.asarray(je))


def test_ef_converges_over_steps():
    """Error feedback: cumulative transmitted ~= cumulative gradient; each
    step's transmission and residual equal to the reference's."""
    rng = np.random.default_rng(1)
    err, jerr = torch.zeros(64), jnp.zeros((64,))
    total_g, total_tx = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        g = rng.normal(size=(64,)).astype(np.float32)
        tx, err = tc.ef_topk_step(_t(g), err, ratio=0.25)
        jtx, jerr = jc.ef_topk_step(jnp.asarray(g), jerr, ratio=0.25)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jtx))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        total_g += _t(g)
        total_tx += tx
    assert_allclose((total_tx + err).numpy(), total_g.numpy(), rtol=1e-4)


def test_int8_quantize_error_bound():
    g = np.random.default_rng(2).normal(size=(1000,)).astype(np.float32)
    q, s = tc.int8_quantize(_t(g))
    rec = tc.int8_dequantize(q, s)
    assert float((rec - _t(g)).abs().max()) <= float(s) * 0.5 + 1e-7
    assert q.dtype == torch.int8
    jq, js = jc.int8_quantize(jnp.asarray(g))
    np.testing.assert_array_equal(rec.numpy(),
                                  np.asarray(jc.int8_dequantize(jq, js)))


def test_topk_ties_at_the_lower_index():
    g = np.array([1.0, -3.0, 3.0, 2.0, -3.0, 0.5, 3.0, -2.0], np.float32)
    for ratio in (0.25, 0.375, 0.5, 0.625):
        got = tc.topk_compress(_t(g), ratio)
        want = jc.topk_compress(jnp.asarray(g), ratio)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        assert got.shape == tuple(want.shape)
        assert got.indices.dtype == torch.int32
    assert tc.topk_compress(_t(g), 0.5).indices.tolist() == [1, 2, 4, 6]
    m = np.random.default_rng(3).integers(-4, 5, size=(6, 7)).astype(np.float32)
    got = tc.topk_decompress(tc.topk_compress(_t(m), 0.3))
    want = jc.topk_decompress(jc.topk_compress(jnp.asarray(m), 0.3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_quantize_bit_equal():
    rng = np.random.default_rng(4)
    cases = [rng.normal(size=(4096,)).astype(np.float32) * 3,
             rng.normal(size=(64, 33)).astype(np.float32) * 1e-3,
             np.zeros((5,), np.float32),
             # scale 1: g / scale lands on halves, rounded to even
             np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)]
    for g in cases:
        q, s = tc.int8_quantize(_t(g))
        jq, js = jc.int8_quantize(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    q, s = tc.int8_quantize(_t(cases[-1]))
    assert float(s) == 1.0 and q.tolist() == [127, 0, 2, 2, 0, -2, 4]


def test_compressed_psum_is_the_references_sum():
    rng = np.random.default_rng(5)
    for n in (1, 2, 4):
        gs = [rng.normal(size=(3, 50)).astype(np.float32) * (i + 1)
              for i in range(n)]
        got = tc.compressed_psum([_t(g) for g in gs])
        qs, scales = zip(*(jc.int8_quantize(jnp.asarray(g)) for g in gs))
        q_sum = np.sum([np.asarray(q, np.int32) for q in qs], axis=0)
        scale_mean = np.float32(np.sum(np.asarray(scales, np.float32),
                                       dtype=np.float32) / np.float32(n))
        want = q_sum.astype(np.float32) * scale_mean
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        if n == 1:   # one participant holds its own dequantized gradient
            np.testing.assert_array_equal(
                got.numpy(), tc.int8_dequantize(*tc.int8_quantize(_t(gs[0]))))
