"""The int8 tensor-core scorer's numerics, on the CPU.

``fused_phase1_quant``'s CUDA kernel splits each f32 query into three int8
pieces, sums the pieces against the codes exactly on the int8 tensor
cores, and combines the sums with a fixed order of f32 steps
(``kernels/fused_phase1/csrc/quant_mma.cuh``).  Here:

* the split's reconstruction bound, by hypothesis, over magnitudes from
  1e-30 to 1e30, all-zero rows and mixed signs (subnormals left out: XLA
  on the CPU flushes them, and no query holds them);
* ``ref.quant_split_scores`` (the kernel's arithmetic in torch) through a
  stable top-``page`` against JAX's fused int8 path, under the reference
  suite's ``_assert_quant_parity`` (rtol 1e-5, atol 1e-4);
* the header's ``split`` and ``combine`` compiled for the host with a stub
  ``cuda_runtime.h``, held bit-equal to the torch version in pieces, row
  scales and scores (skips where no C++ compiler is installed);
* the tensor-core scorer's row stride and launch plan (pure Python).

The kernel itself is held bit-equal to ``quant_split_scores`` on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase A.
"""

import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.fused_phase1 import ops as jops
from repro.kernels.fused_phase1 import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.fused_phase1 import kernel as tkernel
from repro_torch.kernels.fused_phase1 import ref as tref
from test_torch_fused_phase1 import (QUANT_SHAPES, _H100,
                                     _assert_quant_parity, _quant_inputs,
                                     _quant_smem)

_BOUND = 2.0 ** -15 + 2.0 ** -18      # quant_mma.cuh's split error / s


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_split_bound(q):
    pieces, s = tref.quant_split(torch.from_numpy(q))
    p = pieces.numpy().astype(np.float64)
    s = s.numpy().astype(np.float64)
    assert pieces.dtype == torch.int8
    assert np.abs(p[0]).max() <= 127
    assert np.abs(p[1:]).max(initial=0) <= 64
    recon = s[:, None] * (p[0] + p[1] * 2.0 ** -7 + p[2] * 2.0 ** -14)
    err = np.abs(q.astype(np.float64) - recon)
    assert (err <= s[:, None] * _BOUND * (1 + 1e-12)).all()
    zero_rows = ~q.any(axis=1)
    assert (s[zero_rows] == 0).all() and (p[:, zero_rows] == 0).all()


@settings(max_examples=200, deadline=None)
@given(exps=st.lists(st.integers(-30, 30), min_size=1, max_size=6),
       n=st.integers(1, 70), seed=st.integers(0, 2 ** 32 - 1),
       zero_row=st.booleans())
def test_split_reconstruction_bound(exps, n, seed, zero_row):
    """|q - s (p1 + p2 2^-7 + p3 2^-14)| <= s (2^-15 + 2^-18) for every
    value, p1 in [-127, 127], p2 and p3 in [-64, 64]; an all-zero row has
    s = 0 and zero pieces."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.0, 1.0, size=(len(exps), n))
    u[np.abs(u) < 1e-6] = 0.0          # no subnormal values
    q = (u * 10.0 ** np.array(exps, np.float64)[:, None]).astype(np.float32)
    if zero_row:
        q[0] = 0.0
    _assert_split_bound(q)


def test_split_reconstruction_bound_extremes():
    """The bound at the edges: 1e-30 and 1e30 rows, one value per row at
    the row's maximum, both signs, halfway cases of the first piece."""
    q = np.array([[1e-30, -1e-30, 3e-31, 0.0],
                  [1e30, -2.5e29, 1e29, -1e30],
                  [127.0, 0.5, -0.5, 1.5],
                  [0.0, 0.0, 0.0, 0.0]], np.float32)
    _assert_split_bound(q)


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quant_split_scores_vs_jax(shape):
    """quant_split_scores -> stable top-page against JAX's composed int8
    oracle and its fused wrapper (Pallas interpret), on the inputs of the
    port's int8 parity tests."""
    d, n, q, page = shape
    codes, scale, zero, Q, _ = _quant_inputs(d, n, q, sum(shape))
    jargs = [jnp.asarray(a) for a in (codes, scale, zero, Q)]
    got = tref.fused_phase1_quant_split_ref(*_t(codes, scale, zero, Q),
                                            page=page)
    _assert_quant_parity(got, jref.fused_phase1_quant_ref(*jargs, page=page),
                         d)
    _assert_quant_parity(got, jops.fused_phase1_quant(
        *jargs, page=page, force_pallas=True), d)


def test_quant_split_scores_live_mask():
    d, n, q, page = 90, 12, 3, 48
    codes, scale, zero, Q, rng = _quant_inputs(d, n, q, 4)
    live = rng.random(d) < 0.3
    got = tref.fused_phase1_quant_split_ref(*_t(codes, scale, zero, Q),
                                            page=page,
                                            live=torch.from_numpy(live))
    want = jref.fused_phase1_quant_ref(
        *[jnp.asarray(a) for a in (codes, scale, zero, Q)], page=page,
        live=jnp.asarray(live))
    _assert_quant_parity(got, want, d)
    s = got[0].numpy()
    assert (np.isfinite(s).sum(axis=1) == int(live.sum())).all()


# ------------------------------------------------ the header on the host
_HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src"
           / "repro_torch" / "kernels" / "fused_phase1" / "csrc"
           / "quant_mma.cuh")

_STUB = r"""
#pragma once
#include <cstdint>
#define __host__
#define __device__
#define __forceinline__ inline
"""

# stdin: n d Q (ints), codes (d x n int8), queries (Q x n f32), scale (d
# f32), zero (d f32), qsum (Q f32); stdout: pieces (3 x Q x n int8), row
# scales (Q f32), scores (Q x d f32)
_DRIVER = r"""
#include <cmath>
#include <cstdio>
#include <vector>
#include "quant_mma.cuh"

int main() {
  int h[3];
  if (fread(h, 4, 3, stdin) != 3) return 2;
  const int n = h[0], d = h[1], Q = h[2];
  std::vector<int8_t> codes((size_t)d * n), p((size_t)3 * Q * n);
  std::vector<float> x((size_t)Q * n), scale(d), zero(d), qsum(Q), s(Q);
  fread(codes.data(), 1, codes.size(), stdin);
  fread(x.data(), 4, x.size(), stdin);
  fread(scale.data(), 4, d, stdin);
  fread(zero.data(), 4, d, stdin);
  fread(qsum.data(), 4, Q, stdin);
  for (int q = 0; q < Q; ++q) {
    float m = 0.0f;
    for (int k = 0; k < n; ++k) m = std::fmax(m, std::fabs(x[q * n + k]));
    s[q] = quant_mma::row_scale(m);
    for (int k = 0; k < n; ++k)
      quant_mma::split(x[q * n + k], s[q], &p[(0 * Q + q) * n + k],
                       &p[(1 * Q + q) * n + k], &p[(2 * Q + q) * n + k]);
  }
  fwrite(p.data(), 1, p.size(), stdout);
  fwrite(s.data(), 4, Q, stdout);
  for (int q = 0; q < Q; ++q)
    for (int j = 0; j < d; ++j) {
      int a[3] = {0, 0, 0};
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < n; ++k)
          a[i] += p[(i * Q + q) * n + k] * codes[(size_t)j * n + k];
      const float sc = quant_mma::combine(a[0], a[1], a[2], s[q], scale[j],
                                          zero[j], qsum[q]);
      fwrite(&sc, 4, 1, stdout);
    }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_split(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("quant_mma")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "quant_mma.cuh").write_bytes(_HEADER.read_bytes())
    (d / "driver.cpp").write_text(_DRIVER)
    exe = d / "driver"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    f"-I{d}", "-o", str(exe), str(d / "driver.cpp")],
                   check=True, capture_output=True)
    return exe


def _run_host(exe, codes, scale, zero, Q, qsum):
    d, n = codes.shape
    q = Q.shape[0]
    stdin = (np.array([n, d, q], np.int32).tobytes() + codes.tobytes()
             + Q.tobytes() + scale.tobytes() + zero.tobytes()
             + qsum.tobytes())
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         check=True).stdout
    pieces = np.frombuffer(out[:3 * q * n], np.int8).reshape(3, q, n)
    s = np.frombuffer(out[3 * q * n:3 * q * n + 4 * q], np.float32)
    scores = np.frombuffer(out[3 * q * n + 4 * q:], np.float32)
    return pieces, s, scores.reshape(q, d)


@pytest.mark.parametrize("shape", [(64, 8, 1), (300, 16, 4), (513, 32, 8),
                                   (100, 1, 2), (200, 23, 9), (60, 401, 3),
                                   (40, 400, 8)])
def test_header_split_and_combine_bit_equal(host_split, shape):
    """quant_mma.cuh's split, row scale and combine, compiled for the host,
    give quant_split_scores' bits, with an all-zero query row, rows at
    1e-30 and 1e30 among the queries, and docs aligned with a query."""
    d, n, q = shape
    codes, scale, zero, Q, rng = _quant_inputs(d, n, q, d + n)
    Q = Q * np.float32(10.0) ** rng.integers(-3, 4, size=(q, 1)).astype(
        np.float32)
    Q[0] = 0.0
    if q > 2:
        Q[1] *= np.float32(1e-30)
        Q[2] *= np.float32(1e30)
    Q = Q.astype(np.float32)
    # half the docs point along the last query: large sums, whose f32
    # steps round, so another order of the combine would show
    codes[: d // 2] = np.where(Q[-1] >= 0, 127, -127).astype(np.int8)
    qsum = Q.sum(axis=-1).astype(np.float32)
    pieces, s, scores = _run_host(host_split, codes, scale, zero, Q, qsum)
    want_p, want_s = tref.quant_split(torch.from_numpy(Q))
    assert np.array_equal(pieces, want_p.numpy())
    assert np.array_equal(s, want_s.numpy())
    want = tref.quant_split_scores(*_t(codes, scale, zero, Q, qsum))
    assert np.array_equal(scores, want.numpy(), equal_nan=True)


# ------------------------------------------------ stride and launch plan
@pytest.mark.parametrize("n", [1, 12, 16, 23, 32, 256, 400, 401, 416, 4096])
def test_mma_row_stride_is_ldmatrix_conflict_free(n):
    """The tensor-core scorer's staged row stride: at least n, whole and
    odd 16-byte chunks, so the eight rows of an ldmatrix phase (rows
    j .. j + 7 at one 16-byte column) sit in eight different 16-byte bank
    groups (eight groups make the 128 bytes of shared-memory banks)."""
    stride = _build.mma_row_stride(n)
    assert stride >= n and stride % 16 == 0 and (stride // 16) % 2 == 1
    assert stride - n < 32
    for j0 in (0, 5):
        for col in range(0, stride, 16):
            groups = {((j * stride + col) // 16) % 8
                      for j in range(j0, j0 + 8)}
            assert len(groups) == 8
    assert _build.mma_row_stride(400) == 400


@pytest.mark.parametrize("d,Q,n,page", [
    (4_181_504, 32, 400, 320), (131_072, 8, 400, 320), (5001, 9, 23, 33),
    (90, 3, 12, 48), (5000, 4, 400, 5000), (3000, 40, 401, 1024),
    (65_536, 8, 400, 16_384), (1000, 1, 4096, 10)])
def test_quant_plan_sizes(d, Q, n, page):
    """The int8 kernel's plan on an H100: the mma row stride, whole 16-row
    tensor-core tiles per sub-block (one a warp at most), at most 8
    queries a tile (one mma N), a staging buffer within the staging budget
    where a 16-row sub-block allows it, everything within the card's
    shared memory, the fold in shared memory up to next_pow2(page) = 8192
    (past n = 1024 in the workspace), and the splits cover d."""
    smem = _quant_smem(n)
    plan = tkernel._quant_plan(smem, d, Q, n, page, _H100())
    pp = 1 << (page - 1).bit_length()
    assert plan.stride == _build.mma_row_stride(n)
    assert plan.sub % 16 == 0 and plan.sub & (plan.sub - 1) == 0
    assert plan.sub <= plan.tile and plan.tile >= pp
    assert 1 <= plan.block_q <= min(8, Q)
    assert plan.sub <= 16 * _build.THREADS // 32      # a warp a tile
    assert plan.sub * plan.stride <= _build.STAGE_BYTES or plan.sub == 16
    assert smem(plan.block_q, page, plan.tile, plan.sub, plan.stride,
                int(plan.spill)) <= _H100.shared_memory_per_block_optin
    # at n = 4096 the pieces and two 16-row buffers leave no room for
    # the accumulator, which goes to the workspace at any page
    assert plan.spill == (pp > 8192 or n > 1024)
    assert (plan.splits - 1) * plan.chunk < d <= plan.splits * plan.chunk
    if (d, Q, n, page) == (4_181_504, 32, 400, 320):
        assert (plan.block_q, plan.sub, plan.stride) == (8, 128, 400)
