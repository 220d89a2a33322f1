"""repro_torch's device side of the obs plane against the JAX package, on
the CPU: device byte accounting, analytic cost rows, node stats, the
diagnostics bundle, health and device gauges, the bundle validator and
the serving path's host-seam lint.

* **byte tables equal the reference's** -- the flat index's leaf table
  (paths, sections, shapes, numpy dtype names, nbytes) equals the JAX
  package's tree walk exactly; the reference's 4 and 4 x 2
  ``build_sharded`` / ``from_index`` leaves, taken in ONE subprocess on 8
  virtual devices, give the port's ``total_bytes``, sections and leaf
  table exactly.  The stated deviation: the reference's ``per_device``
  charges a replicated leaf once per device (2 x the total at 4 x 2),
  the port's counts each storage once (the total);
* **the accounting is exact** (the JAX suite's pins): quant caches are
  counted, an aliased view counts once, a view is charged its storage,
  totals shrink after ``compact``, reconciliation by storage identity;
* **every building region owns a cost row** -- the build is simulated
  through ``_build.build_listeners`` inside the first plain launch (no
  nvcc here), the rows, ``roofline`` and the fused-vs-composed byte claim
  of ``artifacts/BENCH_kernel_scale.json`` hold;
* **node stats, the bundle and gauges** -- every device a node, the
  bundle's sections the reference's ``BUNDLE_SECTIONS`` (loaded by path)
  for an engine and for a cluster with unwired sections, JSON round trip,
  the validator accepts the bundles and refuses a broken one; health and
  device gauges in the exposition;
* **the lint lints** -- ``tools/check_host_seams_torch.py`` passes the
  repo and catches a planted synchronisation on the serving path.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.cluster import ClusterEngine
from repro_torch.core import VectorIndex
from repro_torch.dist.shard_index import ShardedVectorIndex
from repro_torch.kernels import _build
from repro_torch.kernels.fused_phase1 import ops as fp_ops
from repro_torch.launch import make_shard_mesh
from repro_torch.obs import (BUNDLE_SECTIONS, CompileWatch, MetricsExporter,
                             MetricsRegistry, SlowLog, Tracer, device_bytes,
                             device_gauges, diagnostics_bundle,
                             format_device_line, health_gauges,
                             kernel_byte_ratio, missing_cost_regions,
                             node_stats, prometheus_text,
                             resident_leaf_entries, roofline,
                             verify_kernel_claim, write_diagnostics)
from repro_torch.obs import cost
from repro_torch.serve.engine import BatchedSearchEngine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLAIM = os.path.join(_REPO, "artifacts", "BENCH_kernel_scale.json")

N_DOCS, N_FEAT = 60, 16
CPU = "cpu"


def _mesh(s, r=1):
    return make_shard_mesh(s, r, device=CPU)


@pytest.fixture(scope="module")
def sidx():
    """The JAX suite's fixture: a sealed generation, an active buffer and
    tombstones, so the accounting sees the full segment lifecycle."""
    rng = np.random.default_rng(0)
    idx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(N_DOCS, N_FEAT)).astype(np.float32),
        mesh=_mesh(1), seal_threshold=16)
    idx = idx.add_documents(
        rng.normal(size=(24, N_FEAT)).astype(np.float32))
    return idx.delete(np.array([3, N_DOCS + 2]))


@pytest.fixture()
def queries():
    return np.random.default_rng(1).normal(
        size=(6, N_FEAT)).astype(np.float32)


def _leaf_total(index) -> int:
    """Reference total: the unique views' bytes, off the leaf iterator the
    accounting itself consumes."""
    seen = {}
    for _path, _section, t in resident_leaf_entries(index):
        key = (t.untyped_storage().data_ptr(), t.storage_offset(),
               tuple(t.shape), tuple(t.stride()), t.dtype)
        seen[key if t.numel() else id(t)] = t
    return sum(t.numel() * t.element_size() for t in seen.values())


def _table(dev):
    return [(l["path"], l["section"], tuple(l["shape"]), l["dtype"],
             l["nbytes"]) for l in dev["leaves"]]


# ----------------------------------------------------- against the reference
def test_flat_leaf_table_equals_reference():
    """Paths, sections, shapes, dtype names and bytes of the JAX package's
    tree walk of its flat index, exactly; the lazy int8 table left out by
    both."""
    from repro.core import VectorIndex as JVectorIndex
    from repro.obs import device_bytes as jdevice_bytes

    V = np.random.default_rng(2).normal(size=(N_DOCS, N_FEAT)).astype(
        np.float32)
    jdev = jdevice_bytes(JVectorIndex.build(V))
    idx = VectorIndex.build(V, device=CPU)
    dev = device_bytes(idx)
    assert _table(dev) == _table(jdev)
    assert dev["total_bytes"] == jdev["total_bytes"] == _leaf_total(idx)
    assert dev["sections"] == jdev["sections"] == {"index": 9600}
    assert dev["n_leaves"] == jdev["n_leaves"]
    assert dev["aliased_leaves"] == jdev["aliased_leaves"] == 0
    assert dev["total_bytes"] == sum(l["nbytes"] for l in dev["leaves"])
    assert dev["per_device"] == {"cpu": dev["total_bytes"]}
    rec = dev["reconciliation"]
    assert set(rec) == set(jdev["reconciliation"])
    assert rec["process_live_arrays"] is None
    assert rec["accounted_bytes"] == rec["process_live_bytes"] == 9600
    assert rec["live_leaves"] == dev["n_leaves"]
    idx.quantized                              # the lazy table: not a leaf
    assert device_bytes(idx)["total_bytes"] == dev["total_bytes"]
    line = format_device_line(dev)
    assert "device_bytes total=" in line and "leaves=4" in line


_REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax.numpy as jnp, numpy as np
from repro.core import VectorIndex
from repro.dist.shard_index import ShardedVectorIndex as J
from repro.launch.mesh import make_shard_mesh
from repro.obs import device_bytes

V = np.load(sys.argv[1])
out = {}
for lay, mesh in (("4x1", make_shard_mesh(4)), ("4x2", make_shard_mesh(4, 2))):
    for kind, idx in (
            ("build", J.build_sharded(jnp.asarray(V), mesh)),
            ("from_index", J.from_index(VectorIndex.build(jnp.asarray(V)),
                                        mesh))):
        d = device_bytes(idx)
        out[f"{kind}/{lay}"] = {
            "total": d["total_bytes"], "sections": d["sections"],
            "leaves": d["leaves"], "resident": sum(d["per_device"].values()),
            "n_devices": len(d["per_device"]),
            "aliased": d["aliased_leaves"]}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's device_bytes of its 4 and 4 x 2 layouts, built and
    from a flat index, on 8 virtual devices; one subprocess."""
    V = np.random.default_rng(0).normal(size=(64, N_FEAT)).astype(
        np.float32)
    path = tmp_path_factory.mktemp("ref") / "V.npy"
    np.save(path, V)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path)],
                         env=env, capture_output=True, text=True, cwd=_REPO,
                         timeout=600)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert line, run.stdout + run.stderr
    return V, json.loads(line[0][4:])


@pytest.mark.parametrize("kind", ["build", "from_index"])
@pytest.mark.parametrize("replicas", [1, 2])
def test_sharded_leaf_table_equals_reference(ref_sharded, kind, replicas):
    """The same total, sections and leaf table; the reference charges its
    replicated leaves once per device, the port each storage once."""
    V, out = ref_sharded
    ref = out[f"{kind}/4x{replicas}"]
    mesh = _mesh(4, replicas)
    idx = (ShardedVectorIndex.build_sharded(V, mesh=mesh) if kind == "build"
           else ShardedVectorIndex.from_index(
               VectorIndex.build(V, device=CPU), mesh=mesh))
    dev = device_bytes(idx)
    assert dev["total_bytes"] == ref["total"] == _leaf_total(idx)
    assert dev["sections"] == ref["sections"]
    assert _table(dev) == [(l["path"], l["section"], tuple(l["shape"]),
                            l["dtype"], l["nbytes"]) for l in ref["leaves"]]
    assert dev["aliased_leaves"] == ref["aliased"] == 0
    # the stated deviation: R copies on R devices there, one copy here
    assert ref["resident"] == replicas * ref["total"]
    assert ref["n_devices"] == 4 * replicas
    assert dev["per_device"] == {"cpu": dev["total_bytes"]}


# --------------------------------------------------------- exact accounting
def test_device_bytes_sharded_segmented(sidx):
    dev = device_bytes(sidx)
    assert dev["total_bytes"] == _leaf_total(sidx) > 0
    assert dev["total_bytes"] == sum(l["nbytes"] for l in dev["leaves"])
    assert dev["sections"]["base"] > 0
    assert dev["sections"]["segments"] > 0
    for leaf in dev["leaves"]:
        assert leaf["nbytes"] >= 0 and leaf["dtype"] != "?", leaf
    rec = dev["reconciliation"]
    assert rec["live_leaves"] == dev["n_leaves"]
    assert rec["accounted_bytes"] == dev["total_bytes"]
    assert rec["process_live_bytes"] >= dev["total_bytes"]
    assert rec["device_resident_bytes"] == sum(dev["per_device"].values())


def test_device_bytes_quant_tables_counted(sidx, queries):
    idx = sidx.delete(np.array([5]))        # an instance with no quant yet
    before = device_bytes(idx, reconcile=False)
    assert "quant" not in before["sections"]
    assert "reconciliation" not in before
    idx.search(queries, k=5, page=N_DOCS, engine="fused_int8")
    after = device_bytes(idx, reconcile=False)
    assert after["sections"]["quant"] > 0
    grown = after["total_bytes"] - before["total_bytes"]
    assert grown == after["sections"]["quant"]
    assert after["total_bytes"] == _leaf_total(idx)
    paths = {l["path"] for l in after["leaves"] if l["section"] == "quant"}
    assert {"quant.base.codes", "quant.base.scale", "quant.base.zero",
            "segments[0].quant.codes"} <= paths


def test_device_bytes_shrink_after_compact():
    rng = np.random.default_rng(3)
    idx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(64, N_FEAT)).astype(np.float32), mesh=_mesh(1),
        seal_threshold=16)
    idx = idx.add_documents(rng.normal(size=(32, N_FEAT)).astype(np.float32))
    idx = idx.delete(np.arange(40))
    before = device_bytes(idx, reconcile=False)["total_bytes"]
    compacted = idx.compact()
    after = device_bytes(compacted, reconcile=False)["total_bytes"]
    assert after < before, (after, before)
    assert after == _leaf_total(compacted)


class _Leaves:
    """A test double with its own ``resident_leaves``."""

    def __init__(self, *leaves):
        self.leaves = leaves

    def resident_leaves(self):
        yield from self.leaves


def test_aliased_views_count_once_and_views_pay_their_storage():
    t = torch.arange(100, dtype=torch.float32)
    other = torch.zeros(3, dtype=torch.int8)
    dev = device_bytes(_Leaves(("a", "x", t), ("a_again", "x", t),
                               ("same_view", "x", t[:]),
                               ("head", "y", t[:10]), ("o", "y", other)))
    assert dev["aliased_leaves"] == 2            # t twice more, one view
    assert dev["total_bytes"] == 400 + 40 + 3
    assert dev["sections"] == {"x": 400, "y": 43}
    assert [l["path"] for l in dev["leaves"]] == ["a", "head", "o"]
    assert dev["per_device"] == {"cpu": 403}     # t's storage once
    empty = torch.zeros((0, 4))
    dev = device_bytes(_Leaves(("e", "x", empty), ("f", "x", empty)))
    assert dev["aliased_leaves"] == 0 and dev["n_leaves"] == 2


def test_replica_groups_share_storages(sidx):
    """4 x 2 groups share every tensor: each group's table is the whole
    index's, and a cluster's node counts the storages once."""
    V = np.random.default_rng(4).normal(size=(64, N_FEAT)).astype(np.float32)
    s42 = ShardedVectorIndex.build_sharded(V, mesh=_mesh(4, 2))
    g0, g1 = s42.replica_group(0), s42.replica_group(1)
    d0, d1 = (device_bytes(g, reconcile=False) for g in (g0, g1))
    assert d0["per_device"] == d1["per_device"] == \
        device_bytes(s42, reconcile=False)["per_device"]
    cl = ClusterEngine(s42, batch_size=4, k=5, page=64, trim=None,
                       engine="codes", metrics=MetricsRegistry())
    try:
        ns = node_stats(cl)
    finally:
        cl.close()
    assert ns["total_index_bytes"] == 2 * d0["total_bytes"]
    assert ns["device_resident_bytes"] == d0["per_device"]["cpu"]
    assert ns["nodes"]["cpu"]["index_bytes_by_group"] == {
        0: d0["per_device"]["cpu"], 1: d1["per_device"]["cpu"]}


# ------------------------------------------------------------- cost rows
@pytest.fixture()
def building(monkeypatch):
    """The first plain ``fused_phase1`` launch of the test calls the build
    listeners, as a card's first launch of a library builds it with nvcc
    (inside the wrapper, after the row is filed)."""
    real = fp_ops.ref.fused_phase1_stream
    built = []

    def first_launch_builds(*args, **kwargs):
        if not built:
            built.append(True)
            for fn in list(_build.build_listeners):
                fn("fused_phase1", 0.25)
        return real(*args, **kwargs)

    monkeypatch.setattr(fp_ops.ref, "fused_phase1_stream",
                        first_launch_builds)
    return built


def test_cost_rows_cover_every_built_region(building, queries):
    rng = np.random.default_rng(4)
    idx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(400, 12)).astype(np.float32), mesh=_mesh(1),
        seal_threshold=1024)
    reg = MetricsRegistry()
    watch = CompileWatch(metrics=reg)
    q = queries[:, :12]
    for engine in ("codes", "fused"):
        eng = BatchedSearchEngine(idx, batch_size=4, k=5, page=52,
                                  trim=None, engine=engine, metrics=reg,
                                  compile_watch=watch)
        try:
            for v in q:
                eng.search(v, timeout=60)
        finally:
            eng.close()
    assert building and watch.compiles_total == 1
    assert watch.stats()["by_function"] == {"search.query_phase": 1}
    assert missing_cost_regions(watch) == []
    stats = watch.costs.stats()
    rows = {(r["region"], r["program"]): r for r in stats["rows"]}
    assert set(rows) == {("search.query_phase", "score_codes"),
                         ("search.query_phase", "page_select"),
                         ("search.query_phase", "fused_phase1")}
    # one row per (region, sig, program): the first call writes it, each
    # later call with the key counts a launch
    assert rows["search.query_phase", "fused_phase1"]["launches"] == 6
    assert rows["search.query_phase", "fused_phase1"]["bytes_accessed"] == (
        cost.fused_phase1_work(400, 4, 12, 52, 1, True).nbytes)
    assert rows["search.query_phase", "score_codes"]["bytes_accessed"] == (
        cost.codes_work(400, 4, 12, 1).nbytes)
    # the codes engine's page cut of the joined (base | active) scores
    joined = idx.docs_per_shard + idx.seg_capacity
    assert rows["search.query_phase", "page_select"]["bytes_accessed"] == (
        cost.page_select_work(4, joined, 52).nbytes)
    for region, agg in stats["by_region"].items():
        assert agg["launches"] >= 1 and agg["bytes_accessed"] > 0, region
    ratio = kernel_byte_ratio(watch)
    assert ratio is not None and 0 < ratio["ratio"] < 1.0, ratio
    claim = verify_kernel_claim(watch, _CLAIM)
    assert claim["live"]["ratio"] < 1.0 and claim["claimed_ratio"], claim
    # the committed byte model's ratio, as the reference reads it
    assert claim["claimed_ratio"] == 80_000_000 / 131_200_000
    # a build in a region with no row is reported
    with watch.region("engine.ingest"):
        for fn in list(_build.build_listeners):
            fn("bucketize", 0.1)
    assert missing_cost_regions(watch) == ["engine.ingest"]


def test_roofline_rows():
    watch = CompileWatch(metrics=MetricsRegistry())
    with watch.region("search.query_phase", sig=((32, 400), "codes")):
        cost.record_kernel("score_codes", cost.codes_work(1000, 32, 400, 1))
        cost.record_kernel("code_match",
                           cost.code_match_work(100, 32, 400, 1))
    with watch.region("search.rescore"):
        cost.record_kernel("rerank_topk", cost.rerank_work(32, 10, 400, 320))
    rows = {r["region"]: r for r in roofline(
        watch, {"search.query_phase": 1e-3, "search.rescore": 2e-6,
                "search.merge_select": 1.0, "engine.dispatch": 0.0})}
    assert set(rows) == {"search.query_phase", "search.rescore"}
    main = rows["search.query_phase"]
    w = cost.codes_work(1000, 32, 400, 1)
    assert main["program"] == "score_codes" and main["programs"] == 2
    assert main["bytes_accessed"] == w.nbytes
    assert main["achieved_gbps"] == w.nbytes / 1e-3 / 1e9
    assert main["achieved_gflops"] == w.ops / 1e-3 / 1e9
    assert main["bytes_per_flop"] == w.nbytes / w.ops
    assert rows["search.rescore"]["measured_s"] == 2e-6


def test_cost_row_outside_regions_is_unattributed():
    from repro_torch.obs import active_watch

    before = {(r["region"], r["program"]): r["launches"]
              for r in active_watch().costs.rows()}
    cost.record_kernel("bucketize", cost.bucketize_work(10, 4, 1))
    row = [r for r in active_watch().costs.rows()
           if r["region"] == "<unattributed>" and r["program"] == "bucketize"
           and r["sig"] == []]
    assert row and row[0]["launches"] == before.get(
        ("<unattributed>", "bucketize"), 0) + 1


def test_bound_models_match_the_committed_bounds():
    """The work models behind the bound column: 4.79 ms for the fp32
    kernels, 0.51 for the int8 one, 2.50 for bucketize, 121.36 us for
    rerank_topk at page 8192 on the 4,181,504 x 400 index at Q 32."""
    d, n = 4_181_504, 400
    ms, by = cost.bound_ms(cost.fused_phase1_work(d, 32, n, 320, 1, False))
    assert (round(ms, 2), by) == (4.79, "operations")
    ms, by = cost.bound_ms(cost.code_match_work(d, 32, n, 1))
    assert (round(ms, 2), by) == (4.79, "operations")
    w = cost.quant_work(d, 32, n, 320, False)
    assert w.nbytes == 1_706_186_752
    assert (round(cost.bound_ms(w)[0], 2), cost.bound_ms(w)[1]) == (
        0.51, "bytes")
    ms, by = cost.bound_ms(cost.bucketize_work(d, n, 1))
    assert (round(ms, 2), by) == (2.50, "bytes")
    # the fused and composed phase-1 bytes of the kernel claim
    assert cost.fused_phase1_work(d, 32, n, 320, 1, False).nbytes == \
        1_672_747_520
    assert cost.codes_work(d, 32, n, 1).nbytes == 2_743_130_624


# ------------------------------------------------------------- node stats
def test_node_stats_covers_every_device(sidx):
    eng = BatchedSearchEngine(sidx, batch_size=4, k=5, page=N_DOCS,
                              trim=None, engine="codes",
                              metrics=MetricsRegistry())
    try:
        ns = eng.node_stats()
        dev = eng.device_stats()
    finally:
        eng.close()
    want = {f"cuda:{i}" for i in range(torch.cuda.device_count())} | {"cpu"}
    assert set(ns["nodes"]) == want
    assert ns["n_devices"] == len(want)
    assert ns["total_index_bytes"] == dev["total_bytes"] == \
        device_bytes(sidx, reconcile=False)["total_bytes"]
    assert ns["device_resident_bytes"] == \
        sum(n["index_bytes"] for n in ns["nodes"].values())
    node = ns["nodes"]["cpu"]
    assert node["platform"] == "cpu" and node["memory_stats"] is None
    assert node["index_bytes_by_group"] == {0: dev["per_device"]["cpu"]}


# ------------------------------------------------------- diagnostics bundle
def _reference_sections():
    """BUNDLE_SECTIONS of the JAX package's module, loaded by path."""
    path = os.path.join(_REPO, "src", "repro", "obs", "diagnostics.py")
    spec = importlib.util.spec_from_file_location("_jax_diag", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.BUNDLE_SECTIONS


def test_bundle_sections_are_the_reference_tuple():
    assert BUNDLE_SECTIONS == _reference_sections()


def test_diagnostics_bundle_sections_roundtrip(sidx, queries, tmp_path):
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(sidx, batch_size=4, k=5, page=N_DOCS,
                              trim=None, engine="codes", metrics=reg,
                              tracer=Tracer(sample=1.0),
                              slowlog=SlowLog(threshold_s=0.0, metrics=reg),
                              compile_watch=CompileWatch(metrics=reg))
    exporter = MetricsExporter(reg)
    try:
        for v in queries:
            eng.search(v, timeout=60)
        exporter.collect()
        bundle = diagnostics_bundle(eng, exporter=exporter, reason="test")
        assert tuple(bundle) == _reference_sections()
        assert bundle["meta"]["reason"] == "test"
        assert bundle["meta"]["backend"] == "cpu"
        assert bundle["meta"]["n_devices"] == 1
        assert bundle["stats"]["requests"]["completed"] == len(queries)
        assert bundle["stats"]["compile"]["cost"]["n_rows"] >= 1
        assert bundle["device"]["0"]["total_bytes"] > 0
        assert bundle["cost"]["rows"], "cost rows missing"
        assert bundle["slowlog"]["stats"]["captured"] == len(queries)
        assert bundle["metrics_history"], "exporter history missing"
        assert bundle["health"] is None
        path = write_diagnostics(eng, str(tmp_path), exporter=exporter,
                                 reason="unit test!")
        assert os.path.dirname(path) == str(tmp_path)
        with open(path) as f:
            loaded = json.load(f)
        assert set(_reference_sections()) <= set(loaded)
        assert loaded["meta"]["reason"] == "unit test!"
    finally:
        eng.close()


def test_diagnostics_bundle_cluster_and_unwired_sections(sidx):
    """A bare cluster engine: every section key still present (None or
    empty where the plane is unwired), the device table keyed per
    group."""
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=N_DOCS,
                       trim=None, engine="codes", metrics=MetricsRegistry())
    try:
        bundle = diagnostics_bundle(cl)
        assert set(_reference_sections()) <= set(bundle)
        assert set(bundle["device"]) == {"0", "1"}
        assert bundle["health"]["status"] == "green"
        assert bundle["slowlog"] is None and bundle["traces"] is None
        assert bundle["metrics_history"] == []
        assert bundle["nodes"]["total_index_bytes"] == \
            2 * bundle["device"]["0"]["total_bytes"]
        json.dumps(bundle)
    finally:
        cl.close()


_VALIDATOR = os.path.join(_REPO, "tools", "validate_diag_bundle_torch.py")


def test_validator_accepts_bundles_and_refuses_a_broken_one(sidx, queries,
                                                            tmp_path):
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=N_DOCS,
                       trim=None, engine="codes", metrics=MetricsRegistry())
    try:
        for i, v in enumerate(queries):
            cl.search(v, stream=i)
        write_diagnostics(cl, str(tmp_path), reason="exit")
    finally:
        cl.close()
    out = subprocess.run([sys.executable, _VALIDATOR, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK (1 bundle(s)" in out.stdout
    (bundle_path,) = tmp_path.glob("diagnostics-*.json")
    b = json.loads(bundle_path.read_text())
    del b["cost"]
    b["meta"]["reason"] = "failover"                # green: not mid-incident
    bundle_path.write_text(json.dumps(b))
    out = subprocess.run([sys.executable, _VALIDATOR, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "missing section(s) ['cost']" in out.stderr
    assert "no bundle with reason=exit" in out.stderr


def test_validator_imports_neither_torch_nor_jax(tmp_path):
    """The validator loads the port's sections by path, and nothing else."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['validate', {str(tmp_path)!r}]\n"
            "try:\n"
            f"    runpy.run_path({_VALIDATOR!r}, run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print('BAD', sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('torch', 'jax', 'repro', 'repro_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "BAD []" in out.stdout, out.stdout + out.stderr
    assert "no bundles" in out.stderr


# ------------------------------------------------------------ gauges
def test_health_and_device_gauges(sidx):
    reg = MetricsRegistry()
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=N_DOCS,
                       trim=None, engine="codes", metrics=MetricsRegistry())
    try:
        health_gauges(reg, cl.cluster_health())
        assert reg.value("cluster.health.status") == 0       # green
        assert reg.value("cluster.health.up_groups") == 2
        dev = device_bytes(sidx, reconcile=False)
        device_gauges(reg, dev, group="0")
        assert reg.value("device.index_bytes", group="0") == \
            dev["total_bytes"]
        assert reg.value("device.resident_bytes", device="cpu",
                         group="0") == dev["per_device"]["cpu"]
        text = prometheus_text(reg.snapshot())
        assert "repro_cluster_health_status" in text
        assert "repro_device_index_section_bytes" in text
        cl.mark_down(0)
        health_gauges(reg, cl.cluster_health())
        assert reg.value("cluster.health.status") == 1       # yellow
    finally:
        cl.close()


# ------------------------------------------------------------ host-seam lint
_LINT = os.path.join(_REPO, "tools", "check_host_seams_torch.py")


def test_host_seam_lint_repo_clean():
    out = subprocess.run([sys.executable, _LINT], capture_output=True,
                         text=True, cwd=_REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout


def test_host_seam_lint_catches_violations(tmp_path):
    for rel in ("serve/engine.py", "serve/graphs.py", "core/search.py",
                "cluster/router.py", "dist/shard_index.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("")
    (tmp_path / "serve" / "engine.py").write_text(
        "import torch\n"
        "def serve(x, profile=None):\n"
        "    n = x.sum().item()\n"
        "    if profile is not None:\n"
        "        torch.cuda.synchronize()   # a profile branch: allowed\n"
        "    y = x.cpu()  # host-seam: the answer\n"
        "    return n, y, x.tolist()\n"
        "def profile_phase(x):\n"
        "    torch.cuda.synchronize()       # the fence: allowed\n")
    (tmp_path / "dist" / "shard_index.py").write_text(
        "import torch\n"
        "def delete(x):\n"
        "    return x.cpu()                 # not the search path\n"
        "def _shard_page(x):\n"
        "    torch.cuda.synchronize()\n")
    out = subprocess.run([sys.executable, _LINT, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    flagged = [ln for ln in out.stderr.splitlines() if ": '" in ln]
    assert len(flagged) == 3, out.stderr
    assert "engine.py:3: '.item()'" in out.stderr
    assert "engine.py:7: '.tolist()'" in out.stderr
    assert "shard_index.py:5: 'torch.cuda.synchronize()'" in out.stderr


def test_host_seam_lint_catches_scalar_reads(tmp_path):
    """``int``/``float``/``bool`` of a non-constant, ``.numpy()`` and
    ``.nonzero()`` are host synchronisations too; a constant argument
    and a marked line are not flagged."""
    for rel in ("serve/engine.py", "serve/graphs.py", "core/search.py",
                "cluster/router.py", "dist/shard_index.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("")
    (tmp_path / "core" / "search.py").write_text(
        "def search(x, n):\n"
        "    a = int(x.sum())\n"
        "    b = float(x.max()) + bool(x.any())\n"
        "    c = x.numpy(), x.nonzero()\n"
        "    d = int('3'), float(0.5)\n"
        "    e = int(n)  # host-seam: a host count\n"
        "    return a, b, c, d, e\n")
    out = subprocess.run([sys.executable, _LINT, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    flagged = [ln for ln in out.stderr.splitlines() if ": '" in ln]
    assert len(flagged) == 5, out.stderr
    for line, what in ((2, "int()"), (3, "float()"), (3, "bool()"),
                       (4, ".numpy()"), (4, ".nonzero()")):
        assert f"search.py:{line}: '{what}'" in out.stderr, (what,
                                                              out.stderr)


def test_port_files_import_neither_jax_nor_reference():
    """No import of ``jax`` or ``repro`` in the port's package, in
    ``chip_smoke.py`` or in the port's two tools (read statically, so a
    module-level guard cannot hide one)."""
    import ast
    import pathlib

    root = pathlib.Path(_REPO)
    files = [root / "chip_smoke.py",
             root / "tools" / "check_host_seams_torch.py",
             root / "tools" / "validate_diag_bundle_torch.py",
             *sorted((root / "src" / "repro_torch").rglob("*.py"))]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 60 and bad == [], bad

