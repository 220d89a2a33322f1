"""The idle-time attribution of ``portbench/harness/idle.py`` against
shares worked out by hand on a synthetic device trace and timeline: the
order of precedence, clipping to the window, the collector's pauses
mapped through the anchor, the six shares tiling ``device.idle_pct``,
and readers that give 0.0 where nothing overlaps and nothing for a
program without the timeline."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import idle
from portbench.harness.run_cell import Run
from portbench.harness.spec import Spec
from portbench.harness.trace import DeviceTrace

NAMES = ["batcher.wait", "batcher.form", "search.launch",
         "search.encode", "search.phase1", "search.merge", "search.rescore",
         "search.answer_wait", "batcher.deliver", "ingest.add",
         "ingest.seal", "maintenance.merge", "router.pick"]
OFF = 1_000_000                  # the trace's clock minus the monotonic one
W0, W1 = OFF + 100, OFF + 1100   # a window of 1,000 ns

# (name, thread, t0, t1) on the monotonic clock, ns.  Two batcher threads:
# thread 1 waits to 500, forms, launches, copies, delivers, waits past the
# window, and works again after it; thread 2 waits to 450, launches to
# 900, has no span to 950 and waits past the window.
SPANS = [("batcher.wait", 1, 0, 500), ("batcher.form", 1, 500, 520),
         ("search.launch", 1, 520, 700),
         ("search.encode", 1, 530, 560),
         ("search.answer_wait", 1, 700, 720),
         ("batcher.deliver", 1, 720, 730), ("batcher.wait", 1, 730, 2000),
         ("batcher.form", 1, 2000, 2010), ("search.launch", 1, 2010, 2100),
         ("batcher.wait", 2, 0, 450), ("search.launch", 2, 450, 900),
         ("batcher.wait", 2, 950, 2000),
         ("ingest.add", 3, 320, 420), ("maintenance.merge", 4, 400, 480),
         ("router.pick", 5, 190, 195)]
BUSY = [("k", OFF + 50, OFF + 200), ("late", OFF + 1050, OFF + 1300)]
GC = [(2, 300e-9, 350e-9)]       # (generation, start, stop), seconds

# By hand, idle is [200, 1050): the collector 300-350; the add 350-420;
# the merge 420-480 (over thread 2's launch); host 480-900 (a launch,
# then forms, copies and delivers); 900-950 thread 2 has no span; both
# wait 200-300 and 950-1050.
WANT = {"idle": 85.0, "collector": 5.0, "ingest": 7.0, "merge": 6.0,
        "host": 42.0, "starved": 20.0, "unattributed": 5.0}


def _timeline(spans):
    return {"anchor": {"wall_ns": OFF + 7, "monotonic_ns": 7},
            "names": NAMES,
            "spans": {"t0_ns": np.array([s[2] for s in spans], np.int64),
                      "t1_ns": np.array([s[3] for s in spans], np.int64),
                      "name": np.array([NAMES.index(s[0]) for s in spans],
                                       np.int32),
                      "thread": np.array([s[1] for s in spans], np.int64)},
            "dropped": 0}


def _run(workload, spans=SPANS, timeline=True, discarded=None):
    spec = Spec(workload)
    run = Run(spec, spec.config, spec.mix)
    run.trace = DeviceTrace(BUSY, W0, W1, [])
    run.gc_pauses = GC
    run.t0, run.t_close, run.seconds = 100e-9, 1100e-9, 1000e-9
    run.n_groups = 2
    run.counters0 = {"counters": {}}
    run.counters1 = {"counters": {}}
    if discarded is not None:
        run.counters0["counters"]["maintenance.merges.discarded"] = {
            "group=0": 1}
        run.counters1["counters"]["maintenance.merges.discarded"] = {
            "group=0": 2, "group=1": discarded}
    if timeline:
        run.counters1["timeline"] = _timeline(spans)
    return run, spec


def _read(spec, run, name):
    return spec.reader(name)(run)


def test_portbench_idle_shares_follow_the_order_by_hand():
    run, _ = _run("wiki4x2-int8-ingest")
    got = idle.shares(run)
    assert set(got) == set(WANT)
    for key, want in WANT.items():
        assert got[key] == pytest.approx(want, abs=1e-9), key


def test_portbench_idle_each_rule_wins_where_it_comes_first():
    ns = idle.attribute(W0, W1, [(W0, W0 + 100)],
                        [(300, 350)], _timeline(SPANS))
    # the collector over the add, the add over the merge, the merge over
    # a batcher's launch
    assert (ns["collector"], ns["ingest"], ns["merge"]) == (50, 70, 60)
    # without the collector its time goes to the add
    ns = idle.attribute(W0, W1, [], [], _timeline(SPANS))
    assert ns["collector"] == 0 and ns["ingest"] == 100
    # without the add and the merge, the launch takes their time
    rest = [s for s in SPANS if s[0] not in ("ingest.add",
                                             "maintenance.merge")]
    ns = idle.attribute(W0, W1, [], [], _timeline(rest))
    assert ns["host"] == 450 and ns["merge"] == 0


def test_portbench_idle_clips_to_the_window_and_maps_the_collector():
    # spans and busy time past either edge count only inside the window
    run, _ = _run("wiki4x2-int8-ingest")
    got = idle.shares(run)
    assert sum(got[k] for k in idle.SHARES) == pytest.approx(
        got["idle"], abs=1e-9)
    # the collector's pause, on the monotonic clock, lands 1,000,000 ns
    # later on the trace's: moved out of the window it counts nothing
    run.gc_pauses = [(2, (300 + OFF) * 1e-9, (350 + OFF) * 1e-9)]
    assert idle.shares(_fresh(run))["collector"] == 0.0


def _fresh(run):
    run.__dict__.pop("_idle_shares", None)
    return run


@pytest.mark.parametrize("workload", ["wiki-fused-open",
                                      "wiki4x2-int8-closed",
                                      "wiki4x2-int8-ingest"])
def test_portbench_idle_shares_tile_device_idle_pct(workload):
    run, spec = _run(workload)
    suffix = "" if workload == "wiki-fused-open" else ".qps"
    total = _read(spec, run, "device.idle_pct" + suffix)
    assert total == pytest.approx(85.0, abs=1e-9)
    got = idle.shares(run)
    assert sum(got[k] for k in idle.SHARES) == pytest.approx(total,
                                                            abs=1e-9)
    assert _read(spec, run, "device.idle_host_pct" + suffix) == \
        pytest.approx(42.0, abs=1e-9)
    assert _read(spec, run, "device.idle_starved_pct" + suffix) == \
        pytest.approx(20.0, abs=1e-9)
    # the launches begun in the window: 180 and 450 ns
    assert _read(spec, run, "search.launch_ms" + suffix) == \
        pytest.approx(315e-6)


def test_portbench_idle_readers_give_zero_where_nothing_overlaps():
    quiet = [s for s in SPANS if s[0] not in ("ingest.add",
                                              "maintenance.merge",
                                              "router.pick")]
    run, spec = _run("wiki4x2-int8-ingest", spans=quiet)
    run.gc_pauses = []
    for name in ("device.idle_ingest_pct", "device.idle_merge_pct",
                 "router.pick_ms", "index.merges_discarded"):
        assert _read(spec, run, name) == 0.0, name
    assert idle.shares(run)["collector"] == 0.0
    # no span at all: the device shares are 0.0 and the rest unattributed
    run, spec = _run("wiki4x2-int8-ingest", spans=[])
    run.gc_pauses = []
    assert _read(spec, run, "device.idle_host_pct.qps") == 0.0
    assert _read(spec, run, "device.idle_starved_pct.qps") == 0.0
    assert _read(spec, run, "search.launch_ms.qps") == 0.0
    assert idle.shares(run)["unattributed"] == pytest.approx(85.0)
    # discarded merges are the window's delta per group
    run, spec = _run("wiki4x2-int8-ingest", discarded=3)
    assert _read(spec, run, "index.merges_discarded") == 2.0
    assert _read(spec, run, "router.pick_ms") == pytest.approx(5e-6)


def test_portbench_idle_readers_give_nothing_without_the_timeline():
    """A program without the timeline (no ``timeline`` section), or an
    untraced run, reports none of these metrics and raises nothing."""
    names = ["device.idle_host_pct", "device.idle_host_pct.qps",
             "device.idle_starved_pct", "device.idle_starved_pct.qps",
             "device.idle_ingest_pct", "device.idle_merge_pct",
             "search.launch_ms", "search.launch_ms.qps", "router.pick_ms",
             "index.merges_discarded"]
    run, spec = _run("wiki4x2-int8-ingest", timeline=False, discarded=3)
    for name in names:
        assert _read(spec, run, name) is None, name
    run, spec = _run("wiki4x2-int8-ingest")
    run.trace = None
    for name in names[:6]:
        assert _read(spec, run, name) is None, name
