"""The posting walk's range cut (``kernels/postings_walk/csrc/walk_cut.cuh``)
compiled for the host and held to numpy.

The header is plain C++ apart from the CUDA qualifiers, so with a stub
``cuda_runtime.h`` the host compiler builds the very code the kernels
inline.  A small driver cuts token ranges of a posting row at every edge
of a doc tiling (``edge_cut``), and finds the column of positions of a
flat list of entries (``find_col``).  The ranges come from a stable sort
of random codes, as ``build_postings`` makes them, plus hand-made ones:
empty and reversed ranges, ranges that start or end exactly on a tile
edge, one entry, a whole row; the tilings are ragged (d not a multiple of
the tile), exact, and one tile wider than d.  Skips where no C++ compiler
is installed.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest

_HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src"
           / "repro_torch" / "kernels" / "postings_walk" / "csrc"
           / "walk_cut.cuh")

_STUB = r"""
#pragma once
#define __host__
#define __device__
#define __forceinline__ inline
"""

# stdin: mode (0 cut, 1 find_col), then
#   cut:      d n tile n_tiles n_ranges, docs (n int32), (lo, hi) pairs;
#             stdout: n_ranges x (n_tiles + 1) int32 cuts
#   find_col: C n_e, off (C + 1 int32), e (n_e int32); stdout: n_e int32
_DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
#include "walk_cut.cuh"

static int32_t rd() {
  int32_t v;
  if (fread(&v, 4, 1, stdin) != 1) throw 1;
  return v;
}

int main() {
  const int mode = rd();
  if (mode == 0) {
    const int d = rd(), n = rd(), tile = rd(), n_tiles = rd(), nr = rd();
    std::vector<int32_t> docs(n);
    for (auto& x : docs) x = rd();
    for (int r = 0; r < nr; ++r) {
      const int lo = rd(), hi = rd();
      for (int k = 0; k <= n_tiles; ++k) {
        const int32_t c = walk_cut::edge_cut(docs.data(), lo, hi,
                                             (long long)k * tile, d);
        fwrite(&c, 4, 1, stdout);
      }
    }
  } else {
    const int C = rd(), ne = rd();
    std::vector<int> off(C + 1);
    for (auto& x : off) x = rd();
    for (int i = 0; i < ne; ++i) {
      const int32_t c = walk_cut::find_col(off.data(), C, rd());
      fwrite(&c, 4, 1, stdout);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def cutter(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("walk_cut")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "walk_cut.cuh").write_bytes(_HEADER.read_bytes())
    (d / "driver.cpp").write_text(_DRIVER)
    exe = d / "driver"
    subprocess.run([cxx, "-std=c++17", "-O2", f"-I{d}", "-o", str(exe),
                    str(d / "driver.cpp")], check=True, capture_output=True)
    return exe


def _run(exe, ints) -> np.ndarray:
    out = subprocess.run([str(exe)], input=np.asarray(ints, np.int32)
                         .tobytes(), capture_output=True, check=True).stdout
    return np.frombuffer(out, np.int32)


def _row(d, n_codes, seed):
    """One posting row as build_postings makes it: the doc ids of a
    stable sort of random codes, and each code's range."""
    codes = np.random.default_rng(seed).integers(0, n_codes, d)
    docs = np.argsort(codes, kind="stable").astype(np.int32)
    bounds = np.searchsorted(codes[docs], np.arange(n_codes + 1))
    return docs, list(zip(bounds[:-1], bounds[1:]))


def _want_cuts(docs, lo, hi, tile, n_tiles):
    """Each edge's cut by numpy, and the sub-ranges checked against the
    tiles' members found without the cut."""
    if hi <= lo:
        return np.full(n_tiles + 1, lo)
    part = docs[lo:hi]
    assert (np.diff(part) > 0).all()          # the invariant of the cut
    cuts = lo + np.searchsorted(part, np.arange(n_tiles + 1) * tile)
    cuts[0], cuts[-1] = lo, hi
    for k in range(n_tiles):
        inside = lo + np.flatnonzero(part // tile == k)
        sub = np.arange(cuts[k], cuts[k + 1])
        assert np.array_equal(inside, sub)
    return cuts


@pytest.mark.parametrize("d,tile", [
    (1000, 96),       # ragged: 11 tiles, the last of 40
    (1024, 128),      # exact
    (777, 1024),      # one tile wider than the table
    (4099, 32),       # many narrow tiles, the last of 3
    (50, 7),          # tiles narrower than a range's spacing
])
def test_edge_cut_equals_numpy(cutter, d, tile):
    n_tiles = -(-d // tile)
    docs, ranges = _row(d, 9, d + tile)
    # on the identity row (one ascending range) positions are doc ids, so
    # ranges can start or end exactly on a tile edge: from an edge, up to
    # an edge (the last doc one below it), one whole tile, the whole row,
    # one entry, empty and reversed
    row = np.arange(d, dtype=np.int32)
    edges = [k * tile for k in range(1, n_tiles)] or [d // 2]
    mid = edges[len(edges) // 2]
    row_ranges = [(mid, d), (3, mid), (mid - tile, mid) if mid >= tile
                  else (0, mid), (0, d), (d - 1, d), (5, 5), (7, 3),
                  (edges[0], edges[-1])]
    for docs_, rs in ((docs, ranges + [(5, 5), (7, 3)]), (row, row_ranges)):
        rs = [(int(a), int(b)) for a, b in rs]
        got = _run(cutter, [0, d, d, tile, n_tiles, len(rs), *docs_,
                            *[x for r in rs for x in r]]).reshape(
            len(rs), n_tiles + 1)
        for (lo, hi), g in zip(rs, got):
            assert np.array_equal(g, _want_cuts(docs_, lo, hi, tile,
                                                n_tiles)), (lo, hi)


@pytest.mark.parametrize("lengths", [
    [3, 0, 0, 5, 1, 0, 7, 0],  # empty columns between and at the end
    [0, 0, 4],                 # empty columns first
    [1],                       # one column
    [2] * 400,                 # the benchmark's C
])
def test_find_col_equals_numpy(cutter, lengths):
    off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    C, E = len(lengths), int(off[-1])
    e = np.arange(E, dtype=np.int32)
    got = _run(cutter, [1, C, E, *off, *e])
    want = np.repeat(np.arange(C), lengths)
    assert np.array_equal(got, want)
