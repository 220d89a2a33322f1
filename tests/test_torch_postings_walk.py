"""The posting walk (``kernels/postings_walk``) on the CPU.

* the invariant the card's kernel cuts ranges by: within every token's
  range of every posting table the doc ids ascend, for each path that
  builds a table -- ``build_postings``, a sharded build, a seal, a merge's
  rebuild, a delete's rebuild and a store's commit restored;
* the wrapper sends a CPU tensor to the plain version, which counts no
  launch, and the kernel's launcher refuses CPU tensors;
* the tile the launcher sizes against a card's shared memory: a whole
  number of 32 docs, fitting two blocks an SM, as few tiles as cover d,
  the last never empty, and one tile a query for a table narrower than
  that.

The kernel against the plain version, bit for bit, is in
``tests/test_torch_cuda.py``; the range cut compiled for the host in
``tests/test_torch_postings_walk_host.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import VectorIndex
from repro_torch.core import postings as tpost
from repro_torch.dist import ShardedVectorIndex
from repro_torch.kernels.postings_walk import kernel as pw_kernel
from repro_torch.kernels.postings_walk import ops as pw_ops
from repro_torch.kernels.postings_walk import ref as pw_ref
from repro_torch.launch import make_shard_mesh
from repro_torch.store import latest_commit, restore, write_commit

N_FEAT = 12


def _assert_ranges_ascend(post_docs, post_codes, ctx):
    """Codes ascend along every row, and doc ids ascend wherever two
    neighbours share a code (one token's range)."""
    pd = post_docs.reshape(-1, post_docs.shape[-1]).numpy().astype(np.int64)
    pc = post_codes.reshape(-1, post_codes.shape[-1]).numpy()
    assert (pc[:, 1:] >= pc[:, :-1]).all(), ctx
    same = pc[:, 1:] == pc[:, :-1]
    assert same.any(), ctx                       # some range holds two docs
    assert (pd[:, 1:] > pd[:, :-1])[same].all(), ctx


def _tables(idx):
    """Every (post_docs, post_codes) pair of a sharded index: the base's
    and each sealed generation's."""
    yield "base", idx.post_docs, idx.post_codes
    for i, seg in enumerate(idx.segments):
        yield f"segment {i}", seg.post_docs, seg.post_codes


def _sharded(seed=0, n=64):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    idx = ShardedVectorIndex.build_sharded(
        V, seal_threshold=8, mesh=make_shard_mesh(2, 1, device="cpu"))
    return idx, rng


@pytest.mark.parametrize("path", ["build_postings", "sharded", "seal",
                                  "merge", "delete", "store"])
def test_doc_ids_ascend_within_every_range(path, tmp_path):
    if path == "build_postings":
        codes = torch.from_numpy(np.random.default_rng(1).integers(
            -3, 3, (500, 70)).astype(np.int8))  # three blocks of the sort
        post = tpost.build_postings(codes)
        _assert_ranges_ascend(post.post_docs, post.post_codes, path)
        V = np.random.default_rng(2).normal(size=(300, N_FEAT)).astype(
            np.float32)
        vi = VectorIndex.build(V, device="cpu")
        _assert_ranges_ascend(vi.postings.post_docs, vi.postings.post_codes,
                              "VectorIndex.build")
        return
    idx, rng = _sharded()
    if path in ("seal", "merge", "delete", "store"):
        for _ in range(3):
            idx = idx.add_documents(rng.normal(size=(9, N_FEAT)).astype(
                np.float32))
        assert len(idx.segments) >= 2
    if path == "merge":
        idx = idx.merge_segments(0, 2)
    if path == "delete":
        idx = idx.delete([1, 5, 40, 66, 70])
    if path == "store":
        idx = idx.delete([3, 67])
        write_commit(str(tmp_path), idx, seq=1)
        idx = restore(latest_commit(str(tmp_path)), device="cpu")
    for name, pd, pc in _tables(idx):
        _assert_ranges_ascend(pd, pc, (path, name))


def test_cpu_walk_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(-4, 4, (400, 9)).astype(np.int8))
    post = tpost.build_postings(codes)
    qc = codes[torch.from_numpy(rng.integers(0, 400, 5))]
    lo, hi = tpost.lookup(post, qc)
    hi = torch.where(torch.from_numpy(rng.random((5, 9)) < 0.7), hi, lo)
    w = torch.from_numpy(rng.random((5, 9)).astype(np.float32))
    before = pw_ops.launches
    got = pw_ops.postings_walk(post.post_docs, lo, hi, w)
    assert pw_ops.launches == before
    assert torch.equal(got, pw_ref.postings_walk_ref(post.post_docs, lo, hi,
                                                     w))
    # each cell is its matching columns' weights summed in column order
    want = torch.zeros((5, 400))
    for c in range(9):
        hit = ((codes[None, :, c] == qc[:, None, c])
               & (hi > lo)[:, c, None])
        want += torch.where(hit, w[:, c, None], torch.zeros(()))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        pw_kernel.postings_walk_cuda(post.post_docs, lo, hi, w)


_H100 = dict(smem_per_sm=233472, smem_optin=232448)


def _smem(tile, C):
    """postings_walk.cu's layout: the tile, a chunk of 8,192 staged doc
    ids, then C + 1, C and C 4-byte words and the 16 warp totals, each
    rounded to 16 bytes."""
    up = lambda x: -(-x // 16) * 16                       # noqa: E731
    return (up(4 * tile) + 4 * 8192 + up(4 * (C + 1)) + 2 * up(4 * C)
            + up(64))


@pytest.mark.parametrize("d,C", [(4_181_504, 400), (1_045_376, 400),
                                 (700, 400), (33, 5), (65_537, 4096),
                                 (1, 1)])
def test_tile_width_fits_two_blocks_an_sm(d, C):
    tile, n_tiles = pw_kernel.tile_width(d, C, **_H100, smem_bytes=_smem)
    assert tile % 32 == 0 and tile >= 32
    assert tile * n_tiles >= d > tile * (n_tiles - 1)    # last tile not empty
    assert 2 * (_smem(tile, C) + 1024) <= _H100["smem_per_sm"]
    budget = min(_H100["smem_optin"], _H100["smem_per_sm"] // 2 - 1024)
    t_max = (budget - _smem(0, C)) // 4 // 32 * 32
    assert n_tiles == -(-d // t_max)                     # as few as cover d
    if d <= t_max:
        assert n_tiles == 1


def test_tile_width_refuses_columns_that_leave_no_tile():
    with pytest.raises(ValueError, match="no shared memory"):
        pw_kernel.tile_width(1000, 30_000, **_H100, smem_bytes=_smem)
