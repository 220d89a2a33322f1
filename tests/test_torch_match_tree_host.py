"""The CUDA code-match scorer (``kernels/csrc/match_tree.cuh``) compiled
for the host and held bit-equal to JAX's ``match_scores``.

The header's device helpers are plain C++ apart from a few CUDA names, so
with a stub ``cuda_runtime.h`` (the qualifiers empty, ``float4``,
``__brev``, ``__ffs``) the host compiler builds the very code the kernels
inline.  A small driver scores every (query, doc) cell of the inputs with
``match_tree::cell_score`` on staged rows laid out as the kernels lay
them out: doc rows at ``row_stride``'s odd word stride with random bytes
past C, query rows padded to ``padded_cols(C)`` with zero weights.  Skips
where no C++ compiler is installed.
"""

import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.fused_phase1 import ref as jref
from repro_torch.kernels import _build

_HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src"
           / "repro_torch" / "kernels" / "csrc" / "match_tree.cuh")

_STUB = r"""
#pragma once
#include <cstdint>
#define __host__
#define __device__
#define __forceinline__ inline
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
static Dim3 threadIdx, blockDim{1, 1, 1};
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
"""

# stdin: esize C d Q stride (ints), then the staged doc rows (d x stride
# elements), the padded query codes (Q x cp) and weights (Q x cp f32);
# stdout: the (Q, d) f32 scores
_DRIVER = r"""
#include <cstdio>
#include <vector>
#include "match_tree.cuh"

template <typename T>
void run(int C, int d, int Q, int stride) {
  const int cp = match_tree::padded_cols(C);
  int log_pc = 0;
  while ((1 << log_pc) < C) ++log_pc;
  std::vector<T> rows((size_t)d * stride), qc((size_t)Q * cp);
  std::vector<float4> w4(((size_t)Q * cp + 3) / 4);
  float* w = reinterpret_cast<float*>(w4.data());
  fread(rows.data(), sizeof(T), rows.size(), stdin);
  fread(qc.data(), sizeof(T), qc.size(), stdin);
  fread(w, 4, (size_t)Q * cp, stdin);
  for (int q = 0; q < Q; ++q)
    for (int j = 0; j < d; ++j) {
      const float s = match_tree::cell_score<T>(
          rows.data() + (size_t)j * stride, qc.data() + (size_t)q * cp,
          w + (size_t)q * cp, C, log_pc);
      fwrite(&s, 4, 1, stdout);
    }
}

int main() {
  int h[5];
  if (fread(h, 4, 5, stdin) != 5) return 2;
  if (h[0] == 1) run<int8_t>(h[1], h[2], h[3], h[4]);
  else if (h[0] == 2) run<int16_t>(h[1], h[2], h[3], h[4]);
  else run<int32_t>(h[1], h[2], h[3], h[4]);
  return 0;
}
"""


@pytest.fixture(scope="module")
def scorer(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("match_tree")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "match_tree.cuh").write_bytes(_HEADER.read_bytes())
    (d / "driver.cpp").write_text(_DRIVER)
    exe = d / "driver"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    f"-I{d}", "-o", str(exe), str(d / "driver.cpp")],
                   check=True, capture_output=True)
    return exe


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 37, 64, 65, 400, 401, 800])
def test_cell_score_bit_equal_to_jax(scorer, C, dtype):
    rng = np.random.default_rng(C)
    d, Q = 40, 3
    D = rng.integers(-2, 2, size=(d, C)).astype(dtype)
    Qc = rng.integers(-2, 2, size=(Q, C)).astype(dtype)
    W = (rng.random((Q, C)) * 10 ** rng.uniform(-3, 3, (Q, C))).astype(
        np.float32)
    es = np.dtype(dtype).itemsize
    stride = _build.row_stride(C, es)
    cp = -(-C // 4) * 4
    rows = rng.integers(-128, 128, size=(d, stride)).astype(dtype)
    rows[:, :C] = D                       # random codes past C
    qc = np.zeros((Q, cp), dtype)
    qc[:, :C] = Qc
    w = np.zeros((Q, cp), np.float32)
    w[:, :C] = W
    stdin = (np.array([es, C, d, Q, stride], np.int32).tobytes()
             + rows.tobytes() + qc.tobytes() + w.tobytes())
    out = subprocess.run([str(scorer)], input=stdin, capture_output=True,
                         check=True).stdout
    got = np.frombuffer(out, np.float32).reshape(Q, d)
    want = np.asarray(jref.match_scores(*map(jnp.asarray, (D, Qc, W))))
    assert np.array_equal(got, want)
