"""The page selection (``kernels/page_select``) on the CPU.

* the wrapper sends a CPU tensor to the plain version, ``stable_topk``
  itself, which counts no launch: the same values and positions on the
  rows the kernels have to get right (ties across split edges, all equal,
  -inf rows and ties, signed zeros, page == d, page 1, d no multiple of a
  split or of four), and the kernels' launcher refuses CPU tensors;
* the launch plan: splits that cover each row in whole float4s, all
  resident on the card at once, the page's sort tiles;
* the caller, ``select_page``: the cost row ``page_select`` and the rows
  it adds to the thread's ``page_rows``, and the engine's always-on
  counter ``search.page_select.rows{engine}`` from it, on the flat and the
  sharded index, 0 on the page kernels.

The kernels against ``stable_topk``, bit for bit, are in
``tests/test_torch_cuda.py``; the order keys compiled for the host in
``tests/test_torch_page_select_host.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import TrimFilter, VectorIndex
from repro_torch.core.rerank import stable_topk
from repro_torch.core.search import page_rows, select_page
from repro_torch.dist import ShardedVectorIndex
from repro_torch.kernels.page_select import kernel as ps_kernel
from repro_torch.kernels.page_select import ops as ps_ops
from repro_torch.kernels.page_select import ref as ps_ref
from repro_torch.launch import make_shard_mesh
from repro_torch.obs import CompileWatch, MetricsRegistry
from repro_torch.serve import BatchedSearchEngine

WAIT = 60


def _rows(Q, d, kind, rng) -> torch.Tensor:
    """(Q, d) scores of one adversarial kind."""
    if kind == "ties":          # few values: ties at every split edge
        x = rng.integers(0, 4, (Q, d)).astype(np.float32)
    elif kind == "equal":       # the page is then positions 0 .. page - 1
        x = np.full((Q, d), 0.25, np.float32)
    elif kind == "neg_inf":     # a row of dead docs only, and -inf ties
        x = rng.normal(size=(Q, d)).astype(np.float32)
        x[rng.random((Q, d)) < 0.8] = -np.inf
        x[0] = -np.inf
    else:                       # signed zeros, which rank as one value
        x = np.where(rng.random((Q, d)) < 0.5, -0.0, 0.0).astype(np.float32)
        x[rng.random((Q, d)) < 0.05] = 1.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["ties", "equal", "neg_inf", "zeros"])
@pytest.mark.parametrize("Q,d,page", [(3, 1001, 37), (2, 999, 999),
                                      (4, 4097, 1), (1, 5, 5)])
def test_wrapper_on_the_cpu_is_stable_topk(kind, Q, d, page):
    scores = _rows(Q, d, kind, np.random.default_rng(Q * d + page))
    before = ps_ops.launches
    vals, pos = ps_ops.page_select(scores, page)
    assert ps_ops.launches == before
    want_v, want_p = stable_topk(scores, page)
    assert pos.dtype == torch.int64 and vals.dtype == torch.float32
    assert torch.equal(pos, want_p)
    # bit for bit, -0.0 included
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    if kind == "equal":
        assert torch.equal(pos, torch.arange(page).expand(Q, page))
    assert ps_ref.page_select_ref is stable_topk


def test_kernel_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ps_kernel.page_select_cuda(torch.zeros((2, 8)), 4)


@pytest.mark.parametrize("Q,d,page,n_sm", [
    (32, 4181504, 320, 132),    # the postings cell: 8 splits a row
    (1, 3000, 3000, 132),       # one split: a row shorter than two
    (8, 200003, 320, 132),      # d no multiple of four
    (300, 70001, 5000, 132),    # more queries than resident blocks
    (2, 10**7, 9000, 114),      # the most splits, three sort tiles
])
def test_launch_plan_covers_rows_in_one_wave(Q, d, page, n_sm):
    n, split_len, n_tiles = ps_kernel.launch_plan(Q, d, page, n_sm)
    assert split_len % 4 == 0
    assert n * split_len >= d > (n - 1) * split_len
    assert 1 <= n <= 128
    assert Q * n <= 2 * n_sm or n == 1          # every block resident
    assert split_len >= min(d, 4096)
    assert n_tiles == -(-page // ps_kernel.TILE)
    if (Q, d) == (32, 4181504):
        assert n == 8


def test_select_page_files_its_cost_row_and_tallies_its_rows():
    scores = torch.randn((6, 500), generator=torch.Generator().manual_seed(0))
    watch = CompileWatch(metrics=MetricsRegistry())
    rows = page_rows()
    with watch.region("search.query_phase", sig=("t",)):
        got = select_page(scores, 40)
    one = page_rows() - rows
    select_page(scores, 40)
    (row,) = watch.costs.rows()
    assert row["program"] == "page_select"
    assert row["bytes_accessed"] == 6 * 500 * 4 + 6 * 40 * 12
    assert row["flops"] == 6 * 500
    assert (one, page_rows() - rows) == (6, 12)
    want = stable_topk(scores, 40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _serve(index, queries, engine, reg, batch):
    eng = BatchedSearchEngine(index, batch_size=batch, max_wait_s=WAIT, k=5,
                              page=20, trim=TrimFilter(0.05), engine=engine,
                              metrics=reg)
    try:
        for a in range(0, len(queries), batch):
            for f in [eng.submit(v) for v in queries[a:a + batch]]:
                f.result(timeout=WAIT)
    finally:
        eng.close()


@pytest.mark.parametrize("engine,shards,per_batch", [
    ("postings", 1, 8), ("codes", 1, 8), ("onehot", 1, 8),
    ("codes", 2, 16), ("fused", 1, 0), ("fused_int8", 2, 0)])
def test_page_rows_counter_by_engine(engine, shards, per_batch):
    """A batch of 8 on a composed engine cuts 8 pages a table cut: one
    table on the flat index, one a shard on a sharded one; the page
    kernels cut none, and their counter reads 0."""
    rng = np.random.default_rng(3)
    V = rng.normal(size=(600, 16)).astype(np.float32)
    index = (VectorIndex.build(V, device="cpu") if shards == 1 else
             ShardedVectorIndex.build_sharded(
                 V, mesh=make_shard_mesh(shards, 1, device="cpu")))
    reg = MetricsRegistry()
    _serve(index, V[:16] + 0.01, engine, reg, 8)        # two batches
    assert reg.value("search.page_select.rows", engine=engine) == \
        2 * per_batch
    assert "search.page_select.rows" in reg.snapshot()["counters"]
