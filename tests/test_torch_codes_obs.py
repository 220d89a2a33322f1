"""The ``codes`` engine, the port's default, traced and counted, on the CPU.

* the benchmark's ``wiki-codes-closed`` cell runs at a small size and its
  answers are judged correct, untraced and traced;
* its configuration is ``wiki-lsa400-fused``'s but for its name, its
  deployment, its source, its engine and the guarantee that names it;
* ``search.codes.cells`` equals Q·d·C a batch and ``search.codes.blocks``
  the doc blocks ``score_codes`` walked, on the flat index and on a
  sharded one's bases (its generations, scored by ``code_match``, not);
  both stay 0 on ``fused`` and ``postings``, and the ``postings`` counters
  stay 0 on ``codes``;
* under a recording profiler ``search.codes.score`` is a child of its
  batch's ``search.phase1``, inside it and before ``search.topk``, with
  the doc blocks and the docs a block as its args;
* the check fails on this path: a phase 1 with its weights rounded to
  bfloat16, on seeded rows whose token matches nearly tie, breaks
  ``rank_gap``, where the same phase 1 in float32 passes;
* the new metric readers read nothing, and raise nothing, on a program
  without the span and the counter, and read both from a synthetic run.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import data
from portbench.harness.run_cell import execute
from portbench.harness.spec import BENCH_DIR, ROOT, Spec, load_reader
from portbench.reference.search_ref import Layout, Reference
from portbench.roofline.codes import least_phase1_s
from repro_torch.core import TrimFilter
from repro_torch.core import codes as codes_mod
from repro_torch.core.rerank import rerank_topk, stable_topk
from repro_torch.core.search import (VectorIndex, codes_tally,
                                     phase1_engine_scores)
from repro_torch.dist import ShardedVectorIndex
from repro_torch.launch import make_shard_mesh
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import BatchedSearchEngine

CELL = "wiki-codes-closed"
CONFIG = "wiki-lsa400-codes"
N, NF, TRIM = 2000, 32, 0.05
B = 8                       # queries a batch
STEP = 300                  # docs a block, forced
WAIT = 60
SMALL = {"config": {"corpus": {"docs": 1024, "features": 32}, "page": 16,
                    "batcher": {"batch_size": 8}, "check": {"judged": 16}},
         "mix": {"pool": 1024, "sessions": 16}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_blocks(monkeypatch):
    """``score_codes`` walks blocks of ``STEP`` docs at ``B`` x ``NF``."""
    monkeypatch.setattr(codes_mod, "_BLOCK_ELEMENTS", B * NF * STEP)
    return -(-N // STEP)


def _config(name: str = CONFIG) -> dict:
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def corpus():
    """Snapped unit rows, their flat index and two batches of queries."""
    g = data.generator(39, "cpu")
    base = data.unit_rows(N, NF, g, "cpu", 2, TRIM, 2e-6)
    src = torch.randint(0, N, (2 * B,), generator=g)
    q = data.noisy_copies(base[src], 0.01, g, 2, TRIM, 2e-6)
    return base, VectorIndex.build(base, device="cpu"), q


def _serve(index, q, engine, reg):
    """Serve ``q`` in batches of ``B``, in order, on one engine."""
    eng = BatchedSearchEngine(index, batch_size=B, max_wait_s=WAIT, k=5,
                              page=20, trim=TrimFilter(TRIM), engine=engine,
                              metrics=reg)
    try:
        for a in range(0, q.shape[0], B):
            futs = [eng.submit(v) for v in q[a:a + B].numpy()]
            for f in futs:
                f.result(timeout=WAIT)
    finally:
        eng.close()


# ------------------------------------------------------------ the cell
@pytest.mark.parametrize("trace", [False, True])
def test_codes_cell_is_correct_on_the_cpu(trace):
    out = execute(CELL, 2**31 + 39, 0.7, trace, device="cpu",
                  overrides=SMALL)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = Spec(CELL)
    listed = spec.per_layer if trace else spec.end_to_end
    want = {m["name"] for m in listed}
    # the roofline reads the card's trace, which a CPU run has not got
    want -= {m["name"] for m in listed if m["source"] == "device_trace"}
    assert set(res["metrics"]) == want
    run = out["run"]
    batches, _ = run.hist_delta("engine.dispatch.latency_s")
    assert run.counter_delta("search.codes.cells") > 0
    assert run.counter_delta("search.postings.entries") == 0
    assert run.counter_delta("search.page_select.rows") >= 8 * (batches - 1)


def test_codes_cell_is_the_fused_cell_but_the_engine():
    fused, cfg = _config("wiki-lsa400-fused"), _config()
    assert cfg["engine"] == "codes" and fused["engine"] == "fused"
    differ = {k for k in set(cfg) | set(fused) if cfg.get(k) != fused.get(k)}
    assert differ == {"name", "deployment", "source", "engine",
                      "guarantees"}
    assert cfg["guarantees"][0].startswith(
        "exact answers of the two-phase search")
    assert cfg["check"]["scorer"] == "codes"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {c["name"]: c for c in bench["configs"]}
    mine = entries[CONFIG]
    assert mine["source"] == cfg["source"] and mine["reduced"] == ["docs"]
    # a source of its own: no other configuration's
    assert all(c["source"] != mine["source"] for n, c in entries.items()
               if n != CONFIG)


# ------------------------------------------------------------ counters
@pytest.mark.parametrize("engine", ["codes", "fused", "postings"])
def test_codes_counters_count_the_comparisons_and_the_blocks(
        corpus, small_blocks, engine):
    _, index, q = corpus
    reg = MetricsRegistry()
    _serve(index, q, engine, reg)
    batches = q.shape[0] // B
    if engine == "codes":
        assert reg.value("search.codes.cells") == batches * B * N * NF
        assert reg.value("search.codes.blocks") == batches * small_blocks
        for name in ("entries", "tokens", "rounds"):
            assert reg.value(f"search.postings.{name}") == 0
    else:
        assert reg.value("search.codes.cells") == 0
        assert reg.value("search.codes.blocks") == 0


def test_codes_counters_count_a_sharded_indexs_bases_alone(corpus):
    base, _, q = corpus
    S = 4
    idx = ShardedVectorIndex.build_sharded(
        base, mesh=make_shard_mesh(S, 1, device="cpu"), seal_threshold=16)
    reg = MetricsRegistry()
    _serve(idx, q[:B], "codes", reg)
    # each shard's base scored once: Q x its rows x C, one block each
    dp = -(-N // S)
    assert reg.value("search.codes.cells") == B * S * dp * NF
    assert reg.value("search.codes.blocks") == S
    # a sealed generation is scored by code_match, and not counted
    g = data.generator(40, "cpu")
    grown = idx.add_documents(data.unit_rows(32, NF, g, "cpu", 2, TRIM,
                                             2e-6))
    assert grown.n_segments > 0
    reg = MetricsRegistry()
    _serve(grown, q[:B], "codes", reg)
    assert reg.value("search.codes.cells") == B * S * dp * NF


def test_codes_tally_is_the_threads_running_sum(corpus, small_blocks):
    _, index, q = corpus
    _, qc, w = index.encode_queries(q[:B], TrimFilter(TRIM), None, "idf")
    cells, blocks = codes_tally()
    for _ in range(2):
        phase1_engine_scores(index.codes, index.postings, qc, w, "codes",
                             None, 50)
    phase1_engine_scores(index.codes, index.postings, qc, w, "postings",
                         None, 50)
    c1, b1 = codes_tally()
    assert (c1 - cells, b1 - blocks) == (2 * B * N * NF, 2 * small_blocks)


# --------------------------------------------------------------- spans
def test_codes_score_span_nests_inside_phase1_before_topk(corpus,
                                                          small_blocks):
    _, index, q = corpus
    reg = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(index, q, "codes", reg)
        tl = reg.snapshot()["timeline"]
    assert tl["args"]["search.codes.score"] == ["blocks", "docs_per_block"]
    sp = tl["spans"]
    names = np.asarray(tl["names"])[sp["name"]]
    phase1 = np.flatnonzero(names == "search.phase1")
    assert phase1.size == 2
    for i in phase1:
        mine = np.flatnonzero(sp["parent"] == sp["span"][i])
        mine = mine[np.argsort(sp["t0_ns"][mine], kind="stable")]
        assert tuple(names[mine]) == ("search.codes.score", "search.topk")
        score = mine[0]
        assert (sp["arg0"][score], sp["arg1"][score]) == (small_blocks, STEP)
        assert sp["batch"][score] == sp["batch"][i]
        assert sp["t0_ns"][score] >= sp["t0_ns"][i]
        assert sp["t1_ns"][mine[1]] <= sp["t1_ns"][i]
        assert sp["t0_ns"][mine[1]] >= sp["t1_ns"][score]


# --------------------------------------------------- the check's teeth
@pytest.mark.parametrize("bf16", [False, True])
def test_codes_bf16_phase1_fails_the_check(bf16):
    """Rows of 64 features at P2 share many tokens, so many documents'
    phase-1 scores nearly tie at the page's edge: bfloat16 weights
    reorder them and move answers out of the page."""
    n, nf, page, k = 3000, 64, 64, 10
    g = data.generator(11, "cpu")
    base = data.unit_rows(n, nf, g, "cpu", 2, TRIM, 2e-6)
    src = torch.randint(0, n, (40,), generator=g)
    q = data.noisy_copies(base[src], 0.01, g, 2, TRIM, 2e-6)
    index = VectorIndex.build(base, device="cpu")
    qn, qc, w = index.encode_queries(q, TrimFilter(TRIM), None, "idf")
    if bf16:
        w = w.to(torch.bfloat16).to(torch.float32)
    s1 = phase1_engine_scores(index.codes, index.postings, qc, w, "codes",
                              None, 50)
    _, cand = stable_topk(s1, page)
    ids, scores = rerank_topk(index.vectors, cand, qn, k)
    cfg = _config()
    lim = cfg["check"]["limits"]
    ref = Reference(Layout("codes", 1, page, k, 2, TRIM,
                           float(cfg["check"]["band_rel"])), base)
    got = ref.judge(q, ids.numpy(), scores.numpy())
    assert (got["rank_gap"] > lim["rank_gap"]) == bf16, got
    assert got["score_err"] <= lim["score_err"]


# ------------------------------------------------------------- readers
def _run(timeline=None, counters=None, ops=(), config=None):
    """A finished run as the readers see it: a trace of ``ops``, the
    window [0, 1) s and the counters' deltas over it."""
    c1 = {"counters": {k: {"": v} for k, v in (counters or {}).items()},
          "histograms": {"engine.dispatch.latency_s": {
              "": {"count": 10, "sum": 1.0}}}}
    if timeline is not None:
        c1["timeline"] = timeline
    run = types.SimpleNamespace(
        trace=types.SimpleNamespace(ops=list(ops)), counters0={},
        counters1=c1, t0=0.0, t_close=1.0, config=config or _config())
    run.counter_delta = lambda name: sum(
        c1["counters"].get(name, {}).values())
    run.hist_delta = lambda name: (
        (10, 1.0) if name == "engine.dispatch.latency_s" else (0, 0.0))
    return run


def _reader(name):
    return load_reader(BENCH_DIR / "metrics" / f"{name}.py")


def test_codes_readers_read_nothing_on_a_program_without_the_marks():
    names = ["search.launch", "search.phase1"]
    tl = {"names": names, "spans": {
        "name": np.array([1]), "t0_ns": np.array([10]),
        "t1_ns": np.array([20])}}
    run = _run(timeline=tl, ops=[("k", 0, 10**8)])
    for metric in ("codes.score_ms", "codes_phase1_roofline"):
        assert _reader(metric)(run) is None
    # untraced: no device trace, no timeline
    run = _run(counters={"search.codes.cells": 1.0})
    run.trace = None
    for metric in ("codes.score_ms", "codes_phase1_roofline"):
        assert _reader(metric)(run) is None


def test_codes_readers_read_the_span_and_the_roofline():
    names = ["search.phase1", "search.codes.score", "search.topk"]
    tl = {"names": names, "spans": {
        "name": np.array([0, 1, 2, 1]),
        "t0_ns": np.array([0, 10, 60, 100]),
        "t1_ns": np.array([90, 50, 80, 160])}}
    cfg = _config()
    per_batch = 32 * 4181504 * 400
    run = _run(timeline=tl,
               counters={"search.codes.cells": 10.0 * per_batch},
               ops=[("CompareEqFunctor", 0, 10**9),
                    ("gemv2T_kernel_val", 10**9, 3 * 10**9),
                    ("page_select_hist_kernel", 3 * 10**9,
                     3 * 10**9 + 10**7),
                    # copies and the rescore's kernels are left out
                    ("Memcpy DtoH (Device -> Pageable)", 0, 10**8),
                    ("internal::gemvx::kernel", 0, 10**8),
                    ("radixSortKVInPlace", 0, 10**8),
                    ("vectorized_gather_kernel", 0, 10**8)],
               config=cfg)
    assert _reader("codes.score_ms")(run) == pytest.approx(50e-6)
    got = _reader("codes_phase1_roofline")(run)
    # 3.01 s of phase 1 over ten batches against the scan's bound a batch
    assert least_phase1_s(cfg, per_batch) == pytest.approx(
        3 * 32 * 4181504 * 400 / 33.5e12)
    assert got == pytest.approx(100.0 * least_phase1_s(cfg, per_batch)
                                / 0.301)
    # half the comparisons a batch, half the least time
    assert least_phase1_s(cfg, per_batch / 2) == pytest.approx(
        least_phase1_s(cfg, per_batch) / 2)
