"""The harness on the CPU: traffic that repeats for a seed, the arithmetic
of the end-to-end metrics, the frozen work models, the trace reduction,
and pieces found by name."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from portbench.harness import data, stats, traffic
from portbench.harness.drive import Recorder
from portbench.harness.spec import BENCH_DIR, ROOT, Spec, read_metrics
from portbench.harness.trace import DeviceTrace
from portbench.reference.search_ref import rounding_codes, trim_mask
from portbench.roofline import work


def test_portbench_poisson_offsets_repeat_for_a_seed():
    a = traffic.poisson_offsets(700.0, 5.0, 123456789012)
    b = traffic.poisson_offsets(700.0, 5.0, 123456789012)
    c = traffic.poisson_offsets(700.0, 5.0, 7)
    assert np.array_equal(a, b)
    assert len(a) == len(c) == 3500
    assert not np.array_equal(a, c)
    # the same set of gaps, in another order
    gaps = traffic.poisson_gaps(700.0, 5.0)
    for offs in (a, c):
        last = gaps.sum() - offs[-1]
        np.testing.assert_allclose(np.sort(np.append(np.diff(offs), last)),
                                   gaps, rtol=1e-6, atol=1e-9)
        assert offs[0] == 0.0 and offs[-1] < 5.0


def test_portbench_query_plan_and_rows_repeat_for_a_seed():
    due = traffic.poisson_offsets(200.0, 3.0, 5)
    bulk_due = np.array([-1e9, 0.5, 1.5, 2.5])
    kw = dict(due=due, bulk_due=bulk_due, bulk_rows=64,
              appended_share=0.25, lag_s=0.5)
    p1 = traffic.plan_queries(len(due), 1000, 5, 64, **kw)
    p2 = traffic.plan_queries(len(due), 1000, 5, 64, **kw)
    for x, y in zip((p1.src, p1.bulk, p1.stream), (p2.src, p2.bulk,
                                                    p2.stream)):
        assert np.array_equal(x, y)
    # a query copies only a bulk due at least lag_s before it
    ready = np.searchsorted(bulk_due, due - 0.5, side="right")
    assert np.all(p1.bulk < np.maximum(ready, 1))
    assert 0.15 < np.mean(p1.bulk >= 0) < 0.35
    g1, g2 = data.generator(99, "cpu"), data.generator(99, "cpu")
    r1 = data.unit_rows(256, 32, g1, "cpu", 2, 0.05, 2e-6)
    r2 = data.unit_rows(256, 32, g2, "cpu", 2, 0.05, 2e-6)
    assert torch.equal(r1, r2)
    assert torch.equal(data.noisy_copies(r1, 0.01, g1, 2, 0.05, 2e-6),
                       data.noisy_copies(r2, 0.01, g2, 2, 0.05, 2e-6))


def test_portbench_write_offsets_fill_the_window():
    w = traffic.write_offsets(1.0, 0.5, 20.0)
    assert len(w) == 20 and w[0] == 0.5 and w[-1] == 19.5


def test_portbench_snapped_rows_give_one_set_of_tokens():
    g = data.generator(3, "cpu")
    x = data.unit_rows(2048, 400, g, "cpu", 2, 0.05, 2e-6)
    # any float32 renormalisation moves a value by an ulp or two: no code
    # and no trim decision may change
    y = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    z = x * (1 + 2 ** -22)
    for other in (y, z):
        assert torch.equal(rounding_codes(x, 2), rounding_codes(other, 2))
        assert torch.equal(trim_mask(x, 0.05), trim_mask(other, 0.05))
    norms = torch.linalg.vector_norm(x.double(), dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_portbench_p95_is_over_every_request_and_a_stall_moves_it():
    rng = np.random.default_rng(0)
    n = 2000
    due = np.sort(rng.random(n)) * 10.0
    done = due + 0.040 + 0.005 * rng.random(n)
    ok = np.ones(n, bool)
    lat = stats.latencies_ms(due, done, ok)
    assert len(lat) == n
    base = stats.percentile(lat, 95)
    assert base == pytest.approx(np.percentile(lat, 95))
    # a 1 s stall: every request due in it waits for its end
    stalled = done.copy()
    hit = (due > 4.0) & (due < 5.0)
    stalled[hit] = 5.0 + 0.040
    moved = stats.percentile(stats.latencies_ms(due, stalled, ok), 95)
    assert moved > base + 50
    # not the median of chunk medians: the stall is 10% of the window
    chunks = np.array_split(stats.latencies_ms(due, stalled, ok), 20)
    assert np.median([np.median(c) for c in chunks]) < moved


def test_portbench_qps_is_all_answers_over_all_the_window():
    done = np.array([0.5, 1.0, 9.9, 10.1, 11.0, np.nan])
    ok = np.array([True, True, True, True, False, False])
    assert stats.window_qps(done, ok, 10.0, 10.0) == pytest.approx(0.3)
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_portbench_frozen_work_models_give_the_bring_up_bounds():
    t, by = work.bound_s(work.fused_phase1_work(4181504, 32, 400, 320, 1,
                                                False))
    assert by == "operations" and t * 1e3 == pytest.approx(4.79, abs=5e-3)
    t, by = work.bound_s(work.quant_work(4181504, 32, 400, 320, False))
    assert by == "bytes" and t * 1e3 == pytest.approx(0.51, abs=5e-3)
    t, by = work.bound_s(work.rerank_work(32, 320, 400, 10221))
    assert by == "bytes" and t * 1e6 == pytest.approx(4.92, abs=5e-3)


def test_portbench_trace_busy_union_and_idle_gaps():
    ops = [("k1", 100, 200), ("k2", 150, 260), ("k1", 400, 500),
           ("k3", 0, 120), ("late", 990, 1100)]
    spans = [("ingest.add_documents", 250, 420), ("client.submit", 600, 800)]
    tr = DeviceTrace(ops, 50, 1000, spans)
    assert tr.busy_intervals() == [(50, 260), (400, 500), (990, 1000)]
    assert tr.busy_s == pytest.approx(320e-9)
    assert tr.window_s == pytest.approx(950e-9)
    gaps = tr.idle_gaps(3)
    assert gaps[0][0] == "client.submit"
    assert [round(g[1] * 1e9) for g in gaps] == [490, 140]
    assert gaps[1][0] == "ingest.add_documents"
    assert tr.op_seconds("k1") == (pytest.approx(200e-9), 2)
    assert tr.op_seconds("late", whole=True) == (0.0, 0)


def _copy_bench(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_portbench_new_pieces_are_found_by_name(tmp_path):
    root = _copy_bench(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/wiki-lsa400-fused.json")
                     .read_text())
    cfg["name"] = "wiki-lsa400-fused-b1"
    cfg["batcher"]["batch_size"] = 1
    (root / "portbench/configs/wiki-lsa400-fused-b1.json").write_text(
        json.dumps(cfg))
    (root / "portbench/mixes/trickle.json").write_text(json.dumps(
        {"loop": "open", "rate_qps": 20.0, "streams": 0,
         "queries": {"noise": 0.01}}))
    (root / "portbench/metrics/client.sent.py").write_text(
        "def read(run):\n    return float(run.n_window)\n")
    bench["configs"].append({"name": "wiki-lsa400-fused-b1",
                             "source": "https://arxiv.org/abs/1706.00957",
                             "file": "portbench/configs/"
                                     "wiki-lsa400-fused-b1.json",
                             "reduced": ["docs"], "why": "batches of 1"})
    bench["workloads"].append({"name": "wiki-fused-b1",
                               "config": "wiki-lsa400-fused-b1",
                               "traffic": "trickle", "chips": 1,
                               "why": "20 queries/s, batches of 1"})
    bench["per_layer"].append({"name": "client.sent", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "load generator", "moves": "qps",
                               "workloads": ["wiki-fused-b1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec("wiki-fused-b1", root)
    assert spec.config["batcher"]["batch_size"] == 1
    assert spec.mix["rate_qps"] == 20.0
    assert [m["name"] for m in spec.per_layer][-1] == "client.sent"
    # the metric's reader is found by its name and reads the run

    class FakeRun:
        n_window = 17
        trace = None
        open_loop = True

    got = read_metrics(spec, FakeRun(), [m for m in spec.per_layer
                                         if m["name"] == "client.sent"])
    assert got == {"client.sent": {"value": 17.0, "unit": "count"}}
    # the cells already there still resolve, unchanged
    old = Spec("wiki-fused-open", root)
    assert old.config["batcher"]["batch_size"] == 32


def test_portbench_recorder_counts_failures():
    from concurrent.futures import Future

    rec = Recorder(3, 2)
    f_ok, f_bad = Future(), Future()
    f_ok.add_done_callback(rec.callback(0))
    f_bad.add_done_callback(rec.callback(1))
    f_ok.set_result((np.array([4, 5]), np.array([0.9, 0.8], np.float32)))
    f_bad.set_exception(RuntimeError("engine closed"))
    assert rec.ok.tolist() == [True, False, False]
    assert rec.failed.tolist() == [False, True, False]
    assert rec.ids[0].tolist() == [4, 5]


class _FakeSystem:
    """Answers each submit on a server thread of its own after ``delay``
    seconds; ``block`` maps a query's first value to seconds its submit
    holds the caller, as a lock taken by a write would."""

    def __init__(self, delay=0.002, block=None):
        import threading

        self.delay, self.block = delay, block or {}
        self.submitters = []
        self.server = threading.Thread(target=lambda: None)
        self._lock = threading.Lock()

    def submit(self, q, stream):
        import threading
        import time
        from concurrent.futures import Future

        with self._lock:
            self.submitters.append(threading.current_thread())
        time.sleep(self.block.get(float(q[0]), 0.0))
        fut = Future()

        def serve():
            time.sleep(self.delay)
            fut.set_result((np.arange(2), np.zeros(2, np.float32)))

        t = threading.Thread(target=serve, name="server")
        t.start()
        return fut


def test_portbench_closed_loop_makes_no_send_on_a_server_thread():
    import time

    from portbench.harness import drive

    sysm = _FakeSystem()
    rec = Recorder(4000, 2)
    loop = drive.ClosedLoop(sysm, rec, np.zeros((4000, 4), np.float32), 8,
                            2)
    t0 = time.monotonic()
    loop.start(t0, 0.3)
    time.sleep(0.35)
    loop.senders.close(5.0)
    drive.wait_answers(rec, 5.0)
    n = rec.count
    assert n > 8 * 10
    assert rec.ok[:n].all()
    # every submit came from a client thread, none from a server's
    names = {t.name for t in sysm.submitters}
    assert "server" not in names and len(names) <= 2
    # a session sends its next query only after its last was answered
    assert np.all(rec.sent[8:n] >= np.sort(rec.done[:n])[0])


def test_portbench_open_loop_keeps_its_schedule_while_a_submit_waits():
    import time

    from portbench.harness import drive

    q = np.arange(40, dtype=np.float32)[:, None].repeat(4, 1)
    sysm = _FakeSystem(block={0.0: 0.25})     # query 0 is held 250 ms
    rec = Recorder(40, 2)
    senders = drive.Senders(sysm, rec, q, 2)
    offsets = np.arange(40) * 0.01
    t0 = time.monotonic()
    drive.open_loop(senders, rec, offsets, np.zeros(40, np.int64), t0)
    senders.close(5.0)
    drive.wait_answers(rec, 5.0)
    assert rec.ok.all()
    np.testing.assert_allclose(rec.due, t0 + offsets)
    lag = rec.sent - rec.due
    # the held send is late only for itself: the second client thread
    # sends the queries due meanwhile
    assert np.median(lag[1:20]) < 0.05
    assert rec.done[0] - rec.due[0] >= 0.25


def test_portbench_a_result_is_not_printed_once_jax_is_loaded(
        monkeypatch, capsys):
    import sys
    import types

    from portbench import run
    from portbench.harness.run_cell import FORBIDDEN

    # this process may hold JAX from other tests: hide it for the first
    # look
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    out = {"setup_parts": {}, "checks": {"failed": (0.0, 0.0)},
           "result": {"correct": True}}
    assert run.emit(out) == 0
    assert capsys.readouterr().out.strip().endswith('{"correct": true}')
    # a module loaded after the window closed, by a metric reader say
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert run.emit(out) == 2
    got = capsys.readouterr()
    assert got.out == "" and "jaxlib" in got.err


@pytest.mark.parametrize("workload", ["wiki-fused-open",
                                      "wiki4x2-int8-closed",
                                      "wiki4x2-int8-ingest"])
def test_portbench_each_cell_reports_its_listed_metrics(workload):
    from portbench.harness.run_cell import execute

    ov = {"config": {"corpus": {"docs": 1024, "features": 32}, "page": 16,
                     "batcher": {"batch_size": 8}, "check": {"judged": 8}},
          "mix": {"rate_qps": 60.0, "pool": 1024, "sessions": 8}}
    if "ingest" in workload:
        ov["mix"]["writes"] = {"rows": 32, "period_s": 0.3, "start_s": 0.1}
    spec = Spec(workload)
    for trace, listed in ((False, spec.end_to_end), (True, spec.per_layer)):
        res = execute(workload, 5, 0.7, trace, device="cpu",
                      overrides=ov)["result"]
        want = {m["name"] for m in listed}
        # the kernels' rooflines read the card's trace, which a CPU run
        # has not got
        want -= {m["name"] for m in listed if m["source"] == "device_trace"
                 and "roofline" in m["name"]}
        assert set(res["metrics"]) == want
        assert set(res) >= {"correct", "attempted", "failed", "metrics",
                            "device"}
        assert ("breakdown" in res) is trace
