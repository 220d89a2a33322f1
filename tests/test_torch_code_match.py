"""repro_torch code_match (plain version; the CUDA kernel's arithmetic)
against the JAX reference.

Tolerance rtol/atol 1e-5, the reference suite's own
(``tests/test_kernels.py``): the port's plain version sums over C in
another order than ``code_match_ref`` and the Pallas kernel's ``BLOCK_C``
chunks.  The CUDA kernel sums through the ``match_scores`` tree, whose
bits ``tests/test_torch_fused_phase1.py`` pins against JAX; here the plain
version is also held to that tree at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.code_match import ops as jops
from repro.kernels.code_match.ref import code_match_ref as jref
from repro_torch.kernels.code_match import kernel as tkernel
from repro_torch.kernels.code_match import ops as tops
from repro_torch.kernels.code_match import ref as tref
from repro_torch.kernels.fused_phase1.ref import match_scores

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(d, q, c, dtype, seed):
    rng = np.random.default_rng(seed)
    hi = min(100, np.iinfo(dtype).max)
    D = rng.integers(-hi, hi, size=(d, c)).astype(dtype)
    Q = rng.integers(-hi, hi, size=(q, c)).astype(dtype)
    Q[:, ::2] = D[rng.integers(0, d, size=q)][:, ::2]    # real matches
    W = rng.random((q, c)).astype(np.float32)
    return D, Q, W


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("shape", [(64, 1, 8), (200, 3, 100), (512, 8, 128),
                                   (700, 5, 96), (1024, 2, 17)])
def test_code_match_vs_jax(shape, dtype):
    """The port's wrapper on the CPU against JAX's oracle and its Pallas
    kernel (interpret mode), at the reference suite's shapes."""
    d, q, c = shape
    D, Q, W = _inputs(d, q, c, dtype, d + q + c)
    before = tops.launches
    got = tops.code_match(*map(torch.from_numpy, (D, Q, W)))
    assert tops.launches == before          # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (q, d)
    jargs = [jnp.asarray(a) for a in (D, Q, W)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jref(*jargs)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.code_match(*jargs, force_pallas=True)),
        **TOL)
    np.testing.assert_allclose(
        got.numpy(), match_scores(*map(torch.from_numpy, (D, Q, W))).numpy(),
        **TOL)


def test_cpu_blocks_cannot_move_a_value(monkeypatch):
    """The wrapper's doc blocks on the CPU give the unblocked values."""
    D, Q, W = map(torch.from_numpy, _inputs(301, 4, 23, np.int16, 3))
    want = tref.code_match_ref(D, Q, W)
    for elems in (1, 92 * 7, 1 << 24):
        monkeypatch.setattr(tops, "_CPU_ELEMENTS", elems)
        assert torch.equal(tops.code_match(D, Q, W), want)


def test_self_match_upper_bound():
    """A doc matched against itself scores its full weight sum."""
    rng = np.random.default_rng(5)
    D = torch.from_numpy(rng.integers(-20, 20, size=(32, 24)).astype(np.int8))
    W = torch.from_numpy(rng.random((32, 24)).astype(np.float32))
    got = tops.code_match(D, D, W)
    np.testing.assert_allclose(torch.diagonal(got).numpy(),
                               W.sum(-1).numpy(), rtol=1e-5)
    assert (got <= W.sum(-1)[:, None] + 1e-5).all()


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA launcher never runs the plain version: a CPU tensor is an
    error there, raised before any build."""
    D, Q, W = map(torch.from_numpy, _inputs(10, 1, 4, np.int8, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.code_match_cuda(D, Q, W)
