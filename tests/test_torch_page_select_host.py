"""The page selection's order (``kernels/page_select/csrc/select_key.cuh``)
compiled for the host.

The header is plain C++ apart from the CUDA qualifiers, so with a stub
``cuda_runtime.h`` the host compiler builds the very code the kernels
inline.  A small driver turns f32 scores into their order keys, the
keys' three digits, the prefix test of each pass against a given prefix,
and the rank words of (key, position).  The keys must order scores as
``stable_topk``'s descending stable sort does (-0.0 equal to +0.0, NaN
first, -inf last); the digits must rebuild the key; the rank words must
ascend in the page's order.  The selection itself is held to
``stable_topk`` on the card, in ``tests/test_torch_cuda.py``.  Skips where
no C++ compiler is installed.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.rerank import stable_topk

_HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src"
           / "repro_torch" / "kernels" / "page_select" / "csrc"
           / "select_key.cuh")

_STUB = r"""
#pragma once
#define __host__
#define __device__
#define __forceinline__ inline
"""

# stdin: n, prefix, then n uint32 score bits; stdout per score: key,
# digit 0..2, in_prefix(key, prefix, pass 0..2), rank_word(key, i) as
# (low, high) uint32
_DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
#include "select_key.cuh"

static uint32_t rd() {
  uint32_t v;
  if (fread(&v, 4, 1, stdin) != 1) throw 1;
  return v;
}

int main() {
  const uint32_t n = rd(), prefix = rd();
  for (uint32_t i = 0; i < n; ++i) {
    const uint32_t key = select_key::order_key(rd());
    uint32_t row[9] = {key};
    for (int p = 0; p < select_key::kPasses; ++p) {
      row[1 + p] = select_key::digit(key, p);
      row[4 + p] = select_key::in_prefix(key, prefix, p);
    }
    const uint64_t w = select_key::rank_word(key, i);
    row[7] = (uint32_t)w;
    row[8] = (uint32_t)(w >> 32);
    if (select_key::word_pos(w) != i) throw 2;
    fwrite(row, 4, 9, stdout);
  }
  return 0;
}
"""

SHIFT = (21, 10, 0)
BINS = (2048, 2048, 1024)


@pytest.fixture(scope="module")
def keyer(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("select_key")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "select_key.cuh").write_bytes(_HEADER.read_bytes())
    (d / "driver.cpp").write_text(_DRIVER)
    exe = d / "driver"
    subprocess.run([cxx, "-std=c++17", "-O2", f"-I{d}", "-o", str(exe),
                    str(d / "driver.cpp")], check=True, capture_output=True)
    return exe


def _run(exe, scores, prefix=0) -> np.ndarray:
    bits = np.ascontiguousarray(scores, np.float32).view(np.uint32)
    stdin = np.concatenate([np.array([bits.size, prefix], np.uint32),
                            bits]).tobytes()
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         check=True).stdout
    return np.frombuffer(out, np.uint32).reshape(bits.size, 9)


def _specials(rng) -> np.ndarray:
    """Every kind of f32 a score can be, and many repeats of each."""
    nan = np.float32(np.nan)
    neg_nan = np.frombuffer(np.uint32(0xFFC00001).tobytes(), np.float32)[0]
    tiny = np.float32(1e-45)                     # the least denormal
    vals = np.array([0.0, -0.0, np.inf, -np.inf, nan, neg_nan, tiny, -tiny,
                     np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                     np.finfo(np.float32).max, -np.finfo(np.float32).max,
                     1.0, -1.0, 2.0, 0.5, 3.0, -3.0], np.float32)
    return np.concatenate([vals, rng.choice(vals, 300),
                           rng.normal(size=300).astype(np.float32),
                           rng.integers(-3, 4, 200).astype(np.float32)])


def test_keys_order_as_the_stable_sort(keyer):
    """Sorting positions by key descending, stably, is stable_topk's
    order; keys are equal exactly where the sort sees equal scores."""
    x = _specials(np.random.default_rng(0))
    key = _run(keyer, x)[:, 0].astype(np.int64)
    want = torch.sort(torch.from_numpy(x), descending=True,
                      stable=True).indices.numpy()
    assert np.array_equal(np.argsort(-key, kind="stable"), want)
    nan = np.isnan(x)
    same = (x[:, None] == x[None, :]) | (nan[:, None] & nan[None, :])
    assert np.array_equal(key[:, None] == key[None, :], same)
    assert key[x == -np.inf].max() < key[np.isfinite(x)].min()


def test_digits_rebuild_the_key_and_prefixes_match(keyer):
    rng = np.random.default_rng(1)
    x = _specials(rng)
    prefix = int(rng.integers(0, 2 ** 32))
    out = _run(keyer, x, prefix).astype(np.int64)
    key = out[:, 0]
    for p in range(3):
        assert (out[:, 1 + p] < BINS[p]).all()
    assert np.array_equal((out[:, 1] << 21) | (out[:, 2] << 10) | out[:, 3],
                          key)
    assert out[:, 4].all()
    for p in (1, 2):
        assert np.array_equal(out[:, 4 + p].astype(bool),
                              key >> SHIFT[p - 1] == prefix >> SHIFT[p - 1])
    # against its own key every score is in every prefix
    for i in (0, 5, 40):
        assert _run(keyer, x[i:i + 1], int(key[i]))[0, 4:7].all()


def test_rank_words_ascend_in_page_order(keyer):
    x = _specials(np.random.default_rng(2))
    out = _run(keyer, x).astype(np.uint64)
    word = out[:, 7] | (out[:, 8] << np.uint64(32))
    assert np.array_equal(np.argsort(word, kind="stable"),
                          stable_topk(torch.from_numpy(x), x.size)[1]
                          .numpy())

