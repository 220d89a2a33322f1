"""Serving launcher: build a vector index and serve batched queries.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 10000 \\
        --features 128 --queries 256 --batch-size 32 \\
        [--shards 4 --replicas 2 --merge stream] [--ingest 1000] \\
        [--cluster [--fail-shard 0] [--auto-compact 0.2]] [--device cpu]

The JAX package's launcher (``python -m repro.launch.serve``) for the
port, flag for flag, with the same argument checks, printed lines and
assertions.  It stands the paper's system up end to end on one device
(``--device``, ``cuda`` unless the caller asks for ``cpu``; nothing
falls back to the CPU when the card is missing): synthetic corpus ->
LSA -> encoded index -> :class:`~repro_torch.serve.engine.
BatchedSearchEngine`, then reports quality against the brute-force gold
standard and effective latency/throughput.  ``--shards N`` doc-shards
the index (:class:`~repro_torch.dist.shard_index.ShardedVectorIndex` on
``make_shard_mesh(N, R, device=...)``, every cell one device);
``--replicas R`` adds R replica groups (queries round-robin across them
inside a batch); ``--merge stream`` folds the shard pages into a running
top-k instead of one gather; ``--ingest M`` holds the last M docs out of
the build and hot-adds them through the live engine, so the quality
report covers docs that were never in the built index.  ``--engine``
takes every engine the index serves, the kernels' ``codes_pallas``,
``fused`` and ``fused_int8`` included.

Cluster control plane (:mod:`repro_torch.cluster`): ``--cluster`` serves
through :class:`ClusterEngine` -- one batcher per replica group with
request-stream affinity.  ``--fail-shard G`` injects a failure into
group G after the first pass and re-serves the same queries: the run
asserts the failover results are bit-identical to the healthy cluster,
and that ``_cluster/health`` walks green -> yellow -> green with its
transition ledger reconciled.  ``--auto-compact T`` starts the
background maintenance daemon with tombstone-ratio threshold T, deletes
enough docs to trip it, waits for the background compaction, and
re-serves.

Durability (:mod:`repro_torch.store`): ``--store DIR`` attaches a
translog + commit-point store (fsync before every ack, or ``--durability
async``) with a baseline commit at startup; ``--kill-and-recover``
then drops the in-memory index after serving, crash-recovers from the
directory alone, asserts bit-identical search results, and re-serves
through a fresh engine.

Observability (:mod:`repro_torch.obs`): ``--stats-interval S`` samples
every request into a tracer, prints an ES ``_cat``-style stats line
every S seconds and a final stats + trace dump, and asserts the counters
reconcile with the queries issued; ``--profile`` re-serves every query
with ``_search?profile=true``-style trees and asserts each tree's phases
tile its total and the dispatch phase sums to the dispatch-latency
histogram; ``--slow-threshold S`` attaches the tail-sampled slow log
(S=0 asserts captured == seen); ``--fail-on-recompile`` fails the run on
any ``nvcc`` build attributed to a serving region after the first pass
marks steady state; ``--metrics-file PATH`` writes a JSONL snapshot
history and prints the Prometheus exposition size;
``--diagnostics-on-exit DIR`` writes a diagnostics bundle at the end of
the run and at the moment a failover or kill-and-recover fires
(``tools/validate_diag_bundle_torch.py DIR`` checks them).  Two lines
of the port's own close the output: the SHA-256 of the first pass's
served ids (int64, query-major), so that runs of different engines or
layouts on one corpus can be held to the same answers, and the CUDA
kernels the run launched, by kernel (all 0 on the CPU, where each
wrapper runs its plain version).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.core import (CombinedEncoder, IntervalEncoder,
                              RoundingEncoder, TrimFilter, VectorIndex,
                              brute_force_topk, normalize, precision_at_k)
from repro_torch.core.search import ENGINES
from repro_torch.data import make_corpus
from repro_torch.kernels import launch_counts
from repro_torch.lsa import build_lsa
from repro_torch.serve.engine import BatchedSearchEngine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=10000)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--page", type=int, default=320)
    ap.add_argument("--trim", type=float, default=0.05)
    ap.add_argument("--engine", default="codes", choices=tuple(ENGINES))
    ap.add_argument("--device", default="cuda",
                    help="the device every tensor lives on (cuda unless "
                         "the CPU is asked for)")
    ap.add_argument("--shards", type=int, default=0,
                    help="doc-shard the index N ways (0 = unsharded)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replicate each doc-shard R times (needs --shards; "
                         "queries round-robin across replica groups)")
    ap.add_argument("--merge", default=None,
                    choices=["gather", "stream"],
                    help="sharded merge transport (default: gather; stream = "
                         "the shard pages folded into a running top-k)")
    ap.add_argument("--ingest", type=int, default=0,
                    help="hold back N docs from the build and hot-add them "
                         "through the running engine (needs --shards)")
    ap.add_argument("--cluster", action="store_true",
                    help="serve through the cluster control plane: one "
                         "independent batcher per replica group, stream "
                         "affinity, failover routing (needs --shards)")
    ap.add_argument("--fail-shard", type=int, default=None, metavar="G",
                    help="inject a failure into replica group G after the "
                         "first pass and verify bit-identical failover "
                         "(needs --cluster and --replicas >= 2)")
    ap.add_argument("--auto-compact", type=float, default=None, metavar="T",
                    help="run the background maintenance daemon with "
                         "tombstone-ratio threshold T and demo an "
                         "auto-compaction (needs --cluster)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="attach a durability store (write-ahead translog "
                         "+ commit points) under DIR (needs --shards)")
    ap.add_argument("--durability", default="request",
                    choices=["request", "async"],
                    help="translog fsync policy (request = fsync before "
                         "every ingest ack, the ES default)")
    ap.add_argument("--kill-and-recover", action="store_true",
                    help="after serving, discard the in-memory index, "
                         "crash-recover from --store alone, and assert "
                         "bit-identical search results")
    ap.add_argument("--stats-interval", type=float, default=None,
                    metavar="S",
                    help="print an ES _cat-style stats line every S seconds "
                         "plus a final stats + trace dump; the run then "
                         "asserts the counters reconcile exactly with the "
                         "queries issued (and that --fail-shard recorded "
                         "exactly one down transition)")
    ap.add_argument("--profile", action="store_true",
                    help="after the warm serving pass, re-serve every query "
                         "with _profile-style execution trees, assert each "
                         "tree's phases tile its total exactly and that the "
                         "dispatch phase reconciles with the dispatch "
                         "latency histogram, then print one tree plus "
                         "per-phase p50/p99")
    ap.add_argument("--slow-threshold", type=float, default=None,
                    metavar="S",
                    help="attach the tail-sampled slow log: every request "
                         "slower than S seconds (or failed) is captured at "
                         "100%% regardless of head sampling; S=0 captures "
                         "everything and the run asserts captured == seen")
    ap.add_argument("--metrics-file", default=None, metavar="PATH",
                    help="write a JSONL metrics-snapshot history to PATH "
                         "(one registry snapshot at each serving milestone "
                         "+ final) and print the final Prometheus text "
                         "exposition size")
    ap.add_argument("--diagnostics-on-exit", default=None, metavar="DIR",
                    help="write a one-call diagnostics bundle (stats, "
                         "cluster health, device/cost tables, slow log, "
                         "build stats, metrics history) into DIR at the "
                         "end of the run -- and automatically at the moment "
                         "a --fail-shard failover or --kill-and-recover "
                         "teardown fires, so the bundle captures the state "
                         "an operator would want from the incident")
    ap.add_argument("--fail-on-recompile", action="store_true",
                    help="watch kernel builds per (entry point, shape); "
                         "after the first serving pass marks steady state, "
                         "ANY further attributed build fails the run "
                         "(incompatible with --auto-compact and "
                         "--kill-and-recover, whose post-warmup rebuilds "
                         "are legitimate)")
    return ap


def _check_args(ap, args) -> None:
    if args.replicas > 1 and args.shards < 1:
        ap.error("--replicas needs --shards >= 1")
    if args.merge and args.shards < 1:
        ap.error("--merge needs --shards >= 1")
    if args.ingest and args.shards < 1:
        ap.error("--ingest needs --shards >= 1 (plain VectorIndex is "
                 "immutable)")
    if not 0 <= args.ingest < args.docs:
        ap.error("--ingest must be in [0, --docs)")
    if args.cluster and args.shards < 1:
        ap.error("--cluster needs --shards >= 1")
    if args.fail_shard is not None:
        if not args.cluster or args.replicas < 2:
            ap.error("--fail-shard needs --cluster and --replicas >= 2 "
                     "(failover needs a surviving replica group)")
        if not 0 <= args.fail_shard < args.replicas:
            ap.error(f"--fail-shard must be in [0, {args.replicas})")
    if args.auto_compact is not None and not (args.cluster
                                              and 0 < args.auto_compact < 1):
        ap.error("--auto-compact needs --cluster and a threshold in (0, 1)")
    if args.store and args.shards < 1:
        ap.error("--store needs --shards >= 1 (durability serializes the "
                 "sharded index's canonical flat form)")
    if args.durability != "request" and not args.store:
        ap.error("--durability needs --store (there is no translog to "
                 "apply the policy to)")
    if args.kill_and_recover and not args.store:
        ap.error("--kill-and-recover needs --store")
    if args.stats_interval is not None and args.stats_interval <= 0:
        ap.error("--stats-interval must be positive")
    if args.slow_threshold is not None and args.slow_threshold < 0:
        ap.error("--slow-threshold must be >= 0")
    if args.fail_on_recompile and args.auto_compact is not None:
        ap.error("--fail-on-recompile is incompatible with --auto-compact: "
                 "post-warmup background merges legitimately compile")
    if args.fail_on_recompile and args.kill_and_recover:
        ap.error("--fail-on-recompile is incompatible with "
                 "--kill-and-recover: the post-warmup recovery rebuild "
                 "legitimately compiles")


def _p10(results, gold) -> float:
    ids = torch.from_numpy(np.stack([r[0] for r in results]))
    return float(precision_at_k(ids.to(gold.device), gold).mean())


def _ids_digest(results) -> str:
    """SHA-256 of the served ids, int64 in query order."""
    ids = np.stack([np.asarray(r[0]) for r in results]).astype(np.int64)
    return hashlib.sha256(np.ascontiguousarray(ids).tobytes()).hexdigest()


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    dev = torch.device(args.device)

    print(f"building corpus ({args.docs} docs) + LSA-{args.features} ...")
    corpus = make_corpus(n_docs=args.docs, vocab_size=max(args.docs, 8000),
                         n_topics=64, seed=0)
    pipe = build_lsa(corpus, n_features=args.features, device=dev)
    encoder = CombinedEncoder(RoundingEncoder(1), IntervalEncoder(0.1))
    # gold standard is brute force over the FULL corpus -- including the
    # held-back docs the engine only ever sees through hot ingest -- and
    # needs no encoded index, only the normalized vectors
    rng = np.random.default_rng(1)
    qids = rng.choice(args.docs, size=args.queries, replace=False)
    queries = pipe.doc_vectors[torch.from_numpy(qids).to(dev)].cpu().numpy()
    unit_vecs = normalize(pipe.doc_vectors.to(torch.float32))
    q_unit = unit_vecs[torch.from_numpy(qids).to(dev)]
    gold_ids, _ = brute_force_topk(unit_vecs, q_unit, 10)
    gold_ref = gold_ids            # rebound to the live gold after deletes

    if args.shards > 0:
        from repro_torch.dist.shard_index import ShardedVectorIndex
        from repro_torch.launch.mesh import make_shard_mesh

        mesh = make_shard_mesh(args.shards, args.replicas, device=dev)
        built = args.docs - args.ingest
        print(f"on-device sharded build: {built} docs over {args.shards} "
              f"shard(s) x {args.replicas} replica(s) ...")
        index = ShardedVectorIndex.build_sharded(
            pipe.doc_vectors[:built], encoder=encoder, mesh=mesh)
    else:
        index = VectorIndex.build(pipe.doc_vectors, encoder, device=dev)

    store = None
    if args.store:
        from repro_torch.store import Store, latest_commit

        if latest_commit(args.store, validate=False) is not None:
            ap.error(f"--store {args.store} already holds a commit point; "
                     "this launcher always builds a fresh corpus, so point "
                     "it at a fresh directory")
        store = Store(args.store, durability=args.durability)
        print(f"durability store at {args.store} "
              f"(translog durability={args.durability}, "
              f"seqno={store.seqno})")

    common = dict(batch_size=args.batch_size, k=10, page=args.page,
                  trim=TrimFilter(args.trim) if args.trim else None,
                  engine=args.engine, merge=args.merge)
    tracer = None
    if args.stats_interval:
        from repro_torch.obs import Tracer

        # sample every request: this launcher is a demo/acceptance run,
        # not a steady-state service, so full traces beat low overhead
        tracer = Tracer(capacity=64, sample=1.0)
        common["tracer"] = tracer
    slowlog = None
    if args.slow_threshold is not None:
        from repro_torch.obs import SlowLog

        slowlog = SlowLog(threshold_s=args.slow_threshold, capacity=256)
        common["slowlog"] = slowlog
    watch = None
    if args.fail_on_recompile:
        from repro_torch.obs import active_watch

        # the engines attribute their builds to the process default watch
        # automatically; builds outside a serving region stay
        # <unattributed> and never count against steady state
        watch = active_watch()
    exporter = None
    if args.metrics_file:
        from repro_torch.obs import MetricsExporter, default_registry

        exporter = MetricsExporter(default_registry(),
                                   path=args.metrics_file)
    if args.cluster:
        from repro_torch.cluster import ClusterEngine

        engine = ClusterEngine(index, auto_compact=args.auto_compact,
                               store=store, **common)
        n_streams = 4 * engine.n_groups
        submit = lambda i, q: engine.submit(q, stream=i % n_streams)
        print(f"cluster control plane: {engine.n_groups} replica-group "
              f"batcher(s), {n_streams} request streams")
    else:
        if store is not None:
            index = store.open_index(index)
        engine = BatchedSearchEngine(index, **common)
        submit = lambda i, q: engine.submit(q)

    def dump_diag(reason, eng=None):
        """Write one diagnostics bundle for the CURRENT engine (the
        ``engine`` local is rebound across kill/recover, and the closure
        follows it).  No-op unless --diagnostics-on-exit is set."""
        if not args.diagnostics_on_exit:
            return
        from repro_torch.obs import write_diagnostics

        path = write_diagnostics(eng if eng is not None else engine,
                                 args.diagnostics_on_exit,
                                 exporter=exporter, reason=reason)
        print(f"diagnostics bundle ({reason}) -> {path}", flush=True)

    n_issued = 0
    stats_stop = None
    obs_final = lambda: None
    if args.stats_interval:
        import threading

        from repro_torch.obs import format_stats_line

        stats_stop = threading.Event()
        periodic = engine                 # the engine the printer follows

        def _stats_loop():
            while not stats_stop.wait(args.stats_interval):
                try:
                    print(format_stats_line(periodic.stats()), flush=True)
                except Exception:  # noqa: BLE001 - engine mid-teardown
                    return

        threading.Thread(target=_stats_loop, daemon=True,
                         name="stats-printer").start()
        _obs_done = []

        def obs_final():
            """Stop the printer, dump final stats + traces, and assert
            the reconciliation contract: every query issued is accounted
            for exactly once, and an injected group failure shows up as
            exactly one down transition (THE failover event) plus at
            least one resubmit.  Runs once, BEFORE any kill/recover
            teardown so it sees the engine that served the load."""
            if _obs_done:
                return
            _obs_done.append(True)
            stats_stop.set()
            st = engine.stats()
            print("final " + format_stats_line(st), flush=True)
            req = st["requests"]
            assert req["submitted"] == n_issued, (req, n_issued)
            assert req["completed"] == n_issued, (req, n_issued)
            assert req["failed"] == 0, req
            if args.cluster:
                per_group = req["group_completed"]
                assert sum(per_group.values()) == n_issued, \
                    (per_group, n_issued)
                if args.fail_shard is not None:
                    h, r = st["health"], st["routing"]
                    assert h["down_transitions"] == 1, h
                    assert r["failover_resubmits"] >= 1, r
                    assert h["mark_ups"] + h["readmits"] >= 1, h
            ts = tracer.stats()
            print(f"traces: {ts['retained']} retained "
                  f"({ts['sampled']}/{ts['seen']} sampled)", flush=True)
            dump = tracer.dump()
            if dump:
                last = dump[-1]
                phases = ", ".join(
                    f"{s['name']}={s['duration_s'] * 1e3:.2f}ms"
                    for s in last["spans"] if s["duration_s"] is not None)
                print(f"last trace: {phases}", flush=True)
            print("stats: counters reconcile with the "
                  f"{n_issued} queries issued", flush=True)

    try:
        if args.ingest:
            t0 = time.time()
            first = engine.add_documents(pipe.doc_vectors[-args.ingest:])
            dt = time.time() - t0
            print(f"hot-added {args.ingest} docs (ids {first}.."
                  f"{first + args.ingest - 1}) in {dt*1e3:.1f} ms "
                  f"({args.ingest/dt:.0f} docs/s)")
        t0 = time.time()
        futs = [submit(i, q) for i, q in enumerate(queries)]
        n_issued += len(futs)
        results = [f.result(timeout=120) for f in futs]
        dt = time.time() - t0

        p10 = _p10(results, gold_ids)
        print(f"served {args.queries} queries in {dt:.2f}s "
              f"({dt/args.queries*1e3:.1f} ms/query effective, "
              f"batch={args.batch_size}, engine={args.engine})")
        print(f"P@10 vs brute force: {p10:.3f} "
              f"(trim={args.trim}, page={args.page})")

        if exporter is not None:
            exporter.collect()
        if watch is not None:
            # every library the steady-state service needs is built by
            # the first pass; from here any attributed build is a bug
            watch.mark_steady()
            print(f"compile watch: {watch.compiles_total} compile(s) "
                  "during warmup; steady state marked", flush=True)

        if args.profile:
            from repro_torch.obs import format_profile_tree

            def _find(node, name):
                if node["name"] == name:
                    return node
                for c in node["children"]:
                    hit = _find(c, name)
                    if hit is not None:
                        return hit
                return None

            hist0 = engine.metrics.snapshot()["histograms"].get(
                "engine.dispatch.latency_s", {})
            sum0 = sum(v["sum"] for v in hist0.values())
            trees = []
            t0 = time.time()
            for i, q in enumerate(queries):
                if args.cluster:
                    _, _, tree = engine.profile(q, stream=i % n_streams)
                else:
                    _, _, tree = engine.search(q, profile=True)
                trees.append(tree)
            n_issued += len(trees)
            dt = time.time() - t0
            hist1 = engine.metrics.snapshot()["histograms"].get(
                "engine.dispatch.latency_s", {})
            sum1 = sum(v["sum"] for v in hist1.values())
            phases = {}
            disp_total = 0.0
            for tree in trees:
                q_node = _find(tree, "query")
                assert q_node is not None, tree
                kids = [c for c in q_node["children"]
                        if c["duration_s"] is not None]
                tiled = sum(c["duration_s"] for c in kids)
                assert abs(q_node["duration_s"] - tiled) < 1e-6, \
                    (q_node["duration_s"], tiled)
                disp = _find(tree, "dispatch")
                disp_total += disp["duration_s"]
                for c in kids + disp["children"]:
                    if c.get("duration_s") is not None:
                        phases.setdefault(c["name"], []).append(
                            c["duration_s"])
            # the pass is sequential, so each profiled request is its own
            # batch: the trees' dispatch phase must reconcile with the
            # dispatch-latency histogram delta (float addition error only)
            assert abs((sum1 - sum0) - disp_total) < 1e-6, \
                (sum1 - sum0, disp_total)
            print(f"profile: {len(trees)} trees in {dt:.2f}s -- phases "
                  "tile each total exactly; dispatch reconciles with the "
                  f"latency histogram ({disp_total * 1e3:.1f} ms)",
                  flush=True)
            print(format_profile_tree(trees[0]), flush=True)

            def _q(vals, frac):
                s = sorted(vals)
                return s[min(len(s) - 1, int(frac * len(s)))] * 1e3

            for name in sorted(phases):
                vals = phases[name]
                print(f"  phase {name:<12} p50={_q(vals, 0.5):8.3f}ms "
                      f"p99={_q(vals, 0.99):8.3f}ms  (n={len(vals)})",
                      flush=True)

        if args.fail_shard is not None:
            from repro_torch.obs import format_health_line

            h0 = engine.cluster_health()
            assert h0["status"] == "green", h0
            gen0 = h0["generation"]
            engine.inject_failure(args.fail_shard)
            t0 = time.time()
            futs = [submit(i, q) for i, q in enumerate(queries)]
            n_issued += len(futs)
            down = [f.result(timeout=120) for f in futs]
            dt = time.time() - t0
            # the failpoint trips on first dispatch, failover routing
            # marks the group down mid-serve: health is yellow NOW (the
            # injected fault is a latent failure until traffic finds it,
            # exactly like a dying ES node)
            h1 = engine.cluster_health()
            assert h1["status"] == "yellow", h1
            assert args.fail_shard in h1["down"], h1
            print(format_health_line(h1), flush=True)
            same = all(np.array_equal(a[0], b[0])
                       and np.array_equal(a[1], b[1])
                       for a, b in zip(results, down))
            assert same, "failover results diverged from the healthy cluster"
            print(f"failover: injected failure into group {args.fail_shard}; "
                  f"re-served {args.queries} queries in {dt:.2f}s on "
                  f"groups {engine.health.up_groups()} -- results "
                  f"bit-identical to the healthy cluster")
            dump_diag("failover")
            # recovery: clear the fault and rejoin the group (two separate
            # events, like an ES node rejoin after the fault clears)
            engine.heal(args.fail_shard)
            engine.mark_up(args.fail_shard)
            # _cluster/health reconciliation: the verdict walked green ->
            # yellow -> green, and the transition ledger explains it
            # exactly -- one down event for the failed group since the
            # pre-injection generation, matched one-for-one by the
            # down_transitions counter, plus the recovery up/readmit
            h2 = engine.cluster_health()
            assert h2["status"] == "green", h2
            events = [e for e in h2["transitions"]
                      if e["generation"] > gen0]
            downs = [e for e in events if e["event"] == "down"]
            assert len(downs) == 1 and downs[0]["group"] == args.fail_shard, \
                events
            assert any(e["event"] in ("up", "readmit") for e in events), \
                events
            assert h2["counters"]["down_transitions"] == len(downs), h2
            print(format_health_line(h2) + "  (transitions reconcile: "
                  "green -> yellow -> green, 1 down event, counters match)",
                  flush=True)

        if args.auto_compact is not None:
            # the tombstone ratio is dead / docs-ever-assigned over the
            # WHOLE id space (built + hot-ingested), so size and draw the
            # victims from the whole space too or a big --ingest keeps the
            # ratio under the threshold forever
            n_del = int(min(0.9, 1.5 * args.auto_compact) * args.docs)
            pool = rng.permutation(np.setdiff1d(np.arange(args.docs), qids))
            victims = pool[:n_del]
            if len(victims) <= 1.2 * args.auto_compact * args.docs:
                ap.error("--auto-compact threshold unreachable: too few "
                         "deletable docs (raise --docs or lower --queries "
                         "or the threshold)")
            engine.delete(victims)
            target = max(1, len(engine.health.up_groups()))
            deadline = time.time() + 120
            while (engine.maintenance.compactions < target
                   and time.time() < deadline):
                time.sleep(0.05)
            n_compact = engine.maintenance.compactions
            assert n_compact, "background auto-compaction never fired"
            live_vecs = unit_vecs.clone()
            live_vecs[torch.from_numpy(victims).to(dev)] = 0.0
            gold_live, _ = brute_force_topk(live_vecs, q_unit, 10)
            gold_ref = gold_live
            futs = [submit(i, q) for i, q in enumerate(queries)]
            n_issued += len(futs)
            p10_live = _p10([f.result(timeout=120) for f in futs],
                            gold_live)
            print(f"auto-compact: deleted {n_del} docs (ratio past "
                  f"{args.auto_compact}), background daemon compacted "
                  f"{n_compact} group(s); post-compact P@10 vs live gold: "
                  f"{p10_live:.3f}")

        if args.kill_and_recover:
            from repro_torch.launch.mesh import make_shard_mesh
            from repro_torch.store import recover

            # pre-kill reference on the live index, computed directly (no
            # batcher timing in the comparison); the recovered index is
            # rebuilt on the same mesh SHAPE, so parity is bit-exact at
            # any page, not only page >= n_docs
            live = (engine.group_index(0) if args.cluster
                    else engine.index)
            qs = torch.from_numpy(queries)
            ref_ids, ref_scores = (t.cpu() for t in live.search(
                qs, k=10, page=args.page, engine=args.engine))
            n_ids_before = live.n_ids
            obs_final()                # before the kill: the counters and
            #                            traces belong to the dying engine
            dump_diag("kill-and-recover")
            engine.close()
            del live, index                         # "kill": drop the copy
            t0 = time.time()
            mesh = (make_shard_mesh(args.shards, device=dev) if args.cluster
                    else make_shard_mesh(args.shards, args.replicas,
                                         device=dev))
            recovered, seq = recover(args.store, mesh=mesh)
            dt = time.time() - t0
            assert recovered.n_ids == n_ids_before, \
                (recovered.n_ids, n_ids_before)
            got_ids, got_scores = (t.cpu() for t in recovered.search(
                qs, k=10, page=args.page, engine=args.engine))
            assert torch.equal(got_ids, ref_ids), \
                "recovered ids diverged from the pre-kill live index"
            assert torch.equal(got_scores, ref_scores), \
                "recovered scores diverged from the pre-kill live index"
            print(f"kill-and-recover: crash-recovered {recovered.n_ids} "
                  f"docs from {args.store} (commit + translog replay to "
                  f"seq {seq}) in {dt:.2f}s -- search results BIT-IDENTICAL "
                  f"to the pre-kill live index")
            # and the recovered state serves: a fresh engine over it
            engine = BatchedSearchEngine(recovered, **common)
            t0 = time.time()
            futs = [engine.submit(q) for q in queries]
            p10_rec = _p10([f.result(timeout=120) for f in futs], gold_ref)
            dt = time.time() - t0
            print(f"re-served {args.queries} queries on the recovered "
                  f"index in {dt:.2f}s (P@10 {p10_rec:.3f})")
        obs_final()
        if slowlog is not None:
            ss = slowlog.stats()
            print(f"slowlog: {ss['captured']}/{ss['seen']} captured "
                  f"({ss['slow']} slow, {ss['errors']} errors, threshold "
                  f"{ss['threshold_s'] * 1e3:.0f}ms)", flush=True)
            if args.slow_threshold == 0:
                assert ss["captured"] == ss["seen"], ss
                print("slowlog: tail capture reconciles -- every request "
                      "captured at threshold 0", flush=True)
        if watch is not None:
            cs = watch.stats()
            print(f"recompile watch: {cs['compiles_total']} total, "
                  f"{cs['compiles_steady_state']} post-warmup across "
                  f"{len(cs['by_function'])} entry point(s)", flush=True)
            watch.check()        # raises on any steady-state build
            print("recompile watch: zero steady-state recompiles",
                  flush=True)
        if exporter is not None:
            exporter.collect()
            text = exporter.text()
            print(f"metrics: {len(exporter.history())} snapshot(s) -> "
                  f"{args.metrics_file}; prometheus exposition "
                  f"{len(text.splitlines())} lines", flush=True)
        dump_diag("exit")
        print(f"served ids sha256: {_ids_digest(results)}", flush=True)
        print(f"kernel launches: {json.dumps(launch_counts())}", flush=True)
    finally:
        if stats_stop is not None:
            stats_stop.set()
        engine.close()
        if slowlog is not None:
            slowlog.close()
        if store is not None:
            store.close()


if __name__ == "__main__":
    main()
