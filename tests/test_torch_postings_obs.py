"""The ``postings`` engine's walk, traced and counted, on the CPU.

* the benchmark's ``wiki-postings-closed`` cell runs at a small size and
  its answers are judged correct, untraced and traced;
* ``search.postings.entries`` equals the sum of the document frequencies
  of the batch's kept tokens, counted independently by the benchmark's
  plain reference (``rounding_codes``, ``trim_mask``); ``.tokens`` and
  ``.rounds`` likewise;
* under a recording profiler ``search.postings.sync``, ``.walk`` and
  ``search.topk`` are children of their batch's ``search.phase1``, inside
  it and in that order, ``codes`` holds ``search.codes.score`` before
  ``search.topk``, and ``onehot`` holds ``search.topk`` alone;
* the check fails on this path: a page from posting lists truncated to
  about half the mean kept list breaks ``page_shortfall`` or ``rank_gap`` (an
  eighth of the corpus would truncate nothing: no P2 bucket of Gaussian
  unit rows holds more than 8% of them at d = 400, nor 3% here);
* the walk's cost row, ``score_postings``, holds the least bytes of the
  benchmark's frozen copy;
* the new metric readers read nothing, and raise nothing, on a program
  without the spans and the counters.
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
from portbench.harness.spec import BENCH_DIR, Spec, load_reader
from portbench.reference.search_ref import (Layout, Reference, normalize32,
                                            rounding_codes, trim_mask)
from portbench.roofline.postings import least_phase1_s, walk_bytes
from repro_torch.core import TrimFilter
from repro_torch.core.postings import (WalkTally, lookup,
                                       score_postings_batch)
from repro_torch.core.rerank import rerank_topk, stable_topk
from repro_torch.core.search import VectorIndex, phase1_engine_scores
from repro_torch.obs import CompileWatch, MetricsRegistry, cost
from repro_torch.serve import BatchedSearchEngine

CELL = "wiki-postings-closed"
CONFIG = "wiki-lsa400-postings"
N, NF, TRIM = 2000, 32, 0.05
B = 8                       # queries a batch
WAIT = 60
SMALL = {"config": {"corpus": {"docs": 1024, "features": 32}, "page": 16,
                    "batcher": {"batch_size": 8}, "check": {"judged": 16}},
         "mix": {"pool": 1024, "sessions": 16}}
WALK = ("search.postings.sync", "search.postings.walk", "search.topk")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config() -> dict:
    return json.loads((BENCH_DIR / "configs" / f"{CONFIG}.json").read_text())


@pytest.fixture(scope="module")
def corpus():
    """Snapped unit rows (one set of tokens however they are normalised),
    their flat index and two batches of queries."""
    g = data.generator(35, "cpu")
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


def _reference_walk(base, q):
    """(entries, kept tokens with a posting, columns with an entry) of one
    batch, from the reference's own tokens: each kept query token's
    document frequency over the corpus."""
    codes = rounding_codes(normalize32(base), 2)               # (N, C)
    qn = normalize32(q)
    qc = rounding_codes(qn, 2)                                 # (Q, C)
    kept = trim_mask(qn, TRIM)
    df = (codes[None, :, :] == qc[:, None, :]).sum(1)          # (Q, C)
    df = torch.where(kept, df, 0)
    return (int(df.sum()), int((df > 0).sum()),
            int((df > 0).any(0).sum()))


# ------------------------------------------------------------ the cell
@pytest.mark.parametrize("trace", [False, True])
def test_postings_cell_is_correct_on_the_cpu(trace):
    out = execute(CELL, 2**31 + 35, 0.7, trace, device="cpu",
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
    assert out["run"].counter_delta("search.postings.entries") > 0


def test_postings_cell_is_the_fused_cell_but_the_engine():
    fused = json.loads((BENCH_DIR / "configs"
                        / "wiki-lsa400-fused.json").read_text())
    cfg = _config()
    assert cfg["engine"] == "postings" and fused["engine"] == "fused"
    assert "max_postings" not in cfg
    for key in ("corpus", "encoder", "trim", "page", "k", "layout",
                "batcher", "reduced"):
        assert cfg[key] == fused[key], key
    assert cfg["check"]["scorer"] == "codes"


# ------------------------------------------------------------ counters
def test_postings_entries_counter_is_the_kept_tokens_df(corpus):
    base, index, q = corpus
    reg = MetricsRegistry()
    _serve(index, q, "postings", reg)
    want = [_reference_walk(base, q[a:a + B]) for a in (0, B)]
    assert reg.value("search.postings.entries") == sum(w[0] for w in want)
    assert reg.value("search.postings.tokens") == sum(w[1] for w in want)
    assert reg.value("search.postings.rounds") == sum(w[2] for w in want)


def test_postings_counters_stay_zero_on_another_engine(corpus):
    _, index, q = corpus
    reg = MetricsRegistry()
    _serve(index, q[:B], "codes", reg)
    for name in ("entries", "tokens", "rounds"):
        assert reg.value(f"search.postings.{name}") == 0


def test_postings_walk_tallies_nest():
    g = data.generator(7, "cpu")
    base = data.unit_rows(300, 16, g, "cpu", 2, TRIM, 2e-6)
    idx = VectorIndex.build(base, device="cpu")
    q = data.noisy_copies(base[:4], 0.01, g, 2, TRIM, 2e-6)
    _, qc, w = idx.encode_queries(q, TrimFilter(TRIM), None, "idf")
    with WalkTally() as outer:
        with WalkTally() as inner:
            score_postings_batch(idx.postings, qc, w > 0,
                                 weighting="count", col_weights=w)
        # the inner tally's sums reach the outer one when it closes
        assert (outer.entries, outer.tokens, outer.rounds) == (
            inner.entries, inner.tokens, inner.rounds)
        score_postings_batch(idx.postings, qc, w > 0, weighting="count",
                             col_weights=w)
    assert inner.entries > 0 and inner.rounds > 0
    assert (outer.entries, outer.tokens, outer.rounds) == (
        2 * inner.entries, 2 * inner.tokens, 2 * inner.rounds)
    lo_hi = _reference_walk(base, q)
    assert (inner.entries, inner.tokens, inner.rounds) == lo_hi


# --------------------------------------------------------------- spans
@pytest.mark.parametrize("engine,kids", [
    ("postings", WALK), ("codes", ("search.codes.score", "search.topk")),
    ("onehot", ("search.topk",))])
def test_postings_spans_nest_inside_phase1_in_order(corpus, engine, kids):
    base, index, q = corpus
    reg = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(index, q, engine, reg)
        tl = reg.snapshot()["timeline"]
    sp = tl["spans"]
    names = np.asarray(tl["names"])[sp["name"]]
    phase1 = np.flatnonzero(names == "search.phase1")
    assert phase1.size == 2
    for j, i in enumerate(phase1):
        mine = np.flatnonzero(sp["parent"] == sp["span"][i])
        mine = mine[np.argsort(sp["t0_ns"][mine], kind="stable")]
        assert tuple(names[mine]) == kids
        assert (sp["batch"][mine] == sp["batch"][i]).all()
        t0, t1 = sp["t0_ns"][mine], sp["t1_ns"][mine]
        assert t0[0] >= sp["t0_ns"][i] and t1[-1] <= sp["t1_ns"][i]
        assert (t0[1:] >= t1[:-1]).all() and (t1 >= t0).all()
        if engine == "postings":
            _, tokens, rounds = _reference_walk(base, q[j * B:(j + 1) * B])
            sync = mine[0]
            assert (sp["arg0"][sync], sp["arg1"][sync]) == (tokens, rounds)
            # the walk begins where the sync returned
            assert sp["t0_ns"][mine[1]] >= sp["t1_ns"][sync]
    # the launch's own children are still the three phases
    for i in np.flatnonzero(names == "search.launch"):
        kids_l = names[sp["parent"] == sp["span"][i]]
        assert list(kids_l) == ["search.encode", "search.phase1",
                                "search.rescore"]


# --------------------------------------------------- the check's teeth
@pytest.mark.parametrize("max_postings", [None, N // 128])
def test_postings_truncated_walk_fails_the_check(corpus, max_postings):
    base, index, q = corpus
    cfg = _config()
    lim = cfg["check"]["limits"]
    page, k = 20, 10
    qn, qc, w = index.encode_queries(q, TrimFilter(TRIM), None, "idf")
    lo, hi = lookup(index.postings, qc)
    df = (hi - lo)[w > 0]
    assert int(df.max()) < N // 8 and N // 128 < 0.6 * float(df.double().mean())
    s1 = score_postings_batch(index.postings, qc, w > 0,
                              max_postings=max_postings, weighting="count",
                              col_weights=w)
    _, cand = stable_topk(s1, page)
    ids, scores = rerank_topk(index.vectors, cand, qn, k)
    ref = Reference(Layout("codes", 1, page, k, 2, TRIM,
                           float(cfg["check"]["band_rel"])), base)
    got = ref.judge(q, ids.numpy(), scores.numpy())
    broken = (got["page_shortfall"] > lim["page_shortfall"]
              or got["rank_gap"] > lim["rank_gap"])
    assert broken == (max_postings is not None), got
    assert got["score_err"] <= lim["score_err"]


# ------------------------------------------------------------ cost row
def test_postings_cost_row_holds_the_walks_least_bytes(corpus):
    base, index, q = corpus
    batch = q[:B]
    _, qc, w = index.encode_queries(batch, TrimFilter(TRIM), None, "idf")
    watch = CompileWatch(metrics=MetricsRegistry())
    with watch.region("search.query_phase", sig=((B, NF), "postings")):
        phase1_engine_scores(index.codes, index.postings, qc, w,
                             "postings", None, 50)
    (row,) = watch.costs.rows()
    entries, _, _ = _reference_walk(base, batch)
    assert row["program"] == "score_postings"
    assert row["bytes_accessed"] == entries * 12 + 2 * B * N * 4
    assert row["bytes_accessed"] == walk_bytes(entries, B, N)
    assert row["flops"] == entries
    assert cost.postings_work(entries, B, N).nbytes == row["bytes_accessed"]


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


def test_postings_readers_read_nothing_on_a_program_without_the_walks_marks():
    names = ["search.launch", "search.phase1"]
    tl = {"names": names, "spans": {
        "name": np.array([1]), "t0_ns": np.array([10]),
        "t1_ns": np.array([20])}}
    run = _run(timeline=tl, ops=[("k", 0, 10**8)])
    for metric in ("postings.sync_ms", "postings.walk_ms",
                   "postings_phase1_roofline"):
        assert _reader(metric)(run) is None


def test_postings_readers_read_the_spans_and_the_roofline():
    names = ["search.phase1", "search.postings.sync",
             "search.postings.walk"]
    tl = {"names": names, "spans": {
        "name": np.array([0, 1, 2, 1, 2]),
        "t0_ns": np.array([0, 10, 20, 100, 110]),
        "t1_ns": np.array([90, 20, 60, 130, 170])}}
    entries = 10 * 4.0e8              # ten batches of 4e8 entries
    cfg = _config()
    run = _run(timeline=tl,
               counters={"search.postings.entries": entries},
               ops=[("indexFuncLargeIndex", 0, 6 * 10**8),
                    ("DeviceRadixSortOnesweepKernel", 6 * 10**8, 8 * 10**8),
                    # copies and the rescore's kernels are left out
                    ("Memcpy DtoH (Device -> Pageable)", 0, 10**8),
                    ("gemv2T_kernel_val", 0, 10**8),
                    ("radixSortKVInPlace", 0, 10**8)],
               config=cfg)
    assert _reader("postings.sync_ms")(run) == pytest.approx(20e-6)
    assert _reader("postings.walk_ms")(run) == pytest.approx(50e-6)
    got = _reader("postings_phase1_roofline")(run)
    # 0.8 s of phase 1 over ten batches against the least time a batch
    want = 100.0 * least_phase1_s(cfg, 4.0e8) / 0.08
    assert got == pytest.approx(want)
    walk_s = walk_bytes(4.0e8, 32, 4181504) / 3.35e12
    assert least_phase1_s(cfg, 4.0e8) == pytest.approx(walk_s)
