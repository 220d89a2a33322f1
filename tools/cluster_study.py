#!/usr/bin/env python3
"""What two replica-group batchers do on one card: ClusterEngine's two
groups against one, and throw-away variants of how the groups dispatch.

    python3 tools/cluster_study.py

Builds an index of phase C's shape in ``chip_smoke.py`` (4,181,504 x 400
seeded unit rows, ``RoundingEncoder(2)``, 128 noisy corpus rows as
queries), views it as 4 doc-shards x 2 replica groups
(``ShardedVectorIndex.from_index``, as phase J does) and serves
``fused_int8`` (batch 32, max_wait_s 0.005, page 320, k 10, trim 0.05)
through ``ClusterEngine`` by 16 client streams of 128 open-loop requests
(``chip_smoke.j_drive``), every variant once a round, seven rounds:

* ``1 group`` -- the 4 x 1 group alone;
* ``2 groups`` -- both groups as the package serves them: every
  batcher's kernels on the default stream, so each batch's copy of its
  answers to the host also waits for the other group's kernels;
* ``2 groups, streams`` -- each group's searches on a stream of its own,
  which first waits for the default stream's work (a write's kernels)
  and is synchronised before the answers leave the search, so a batch
  waits for its own kernels only (a throw-away patch of
  ``repro_torch.cluster.router._FailpointIndex.search``; the package is
  not changed);
* ``1 group, switch 0.5 ms`` and ``2 groups, switch 0.5 ms`` -- the
  interpreter's thread switch interval cut from 5 ms to 0.5 ms
  (``sys.setswitchinterval``), so a thread woken from a device wait gets
  the interpreter back sooner.

Every answer of every variant is held bit-equal to the first run's for
its row.  Then one traced pair of batches (one a group) for each
2-group variant (``chip_smoke.trace_groups``): host time, device busy
time, idle share, each group's device time and what no group's thread
launched.  Prints one JSON object, after the card's name and power
limit.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402  (the repo root's script)

ROUNDS = 7
STREAMS = 16


@contextlib.contextmanager
def group_streams():
    """Each group's searches on a stream of its own (see the module
    doc)."""
    from repro_torch.cluster import router

    real = router._FailpointIndex.search
    streams = {}

    def search(self, *args, **kwargs):
        key = id(self._cell)
        if key not in streams:
            streams[key] = torch.cuda.Stream()
        s = streams[key]
        s.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(s):
            out = real(self, *args, **kwargs)
        s.synchronize()
        return out

    router._FailpointIndex.search = search
    try:
        yield
    finally:
        router._FailpointIndex.search = real


@contextlib.contextmanager
def switch_interval(seconds: float):
    old = sys.getswitchinterval()
    sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


VARIANTS = (
    ("1 group", 1, contextlib.nullcontext),
    ("2 groups", 2, contextlib.nullcontext),
    ("2 groups, streams", 2, group_streams),
    ("1 group, switch 0.5 ms", 1, lambda: switch_interval(5e-4)),
    ("2 groups, switch 0.5 ms", 2, lambda: switch_interval(5e-4)),
)


def build():
    """-> (the 4 x 2 index, its 4 x 1 group, the queries)."""
    from repro_torch.core import RoundingEncoder, VectorIndex
    from repro_torch.dist import ShardedVectorIndex
    from repro_torch.launch import make_shard_mesh

    gen = torch.Generator(device="cuda").manual_seed(0)
    vectors = torch.randn((cs.N_DOCS, cs.N_FEATURES), generator=gen,
                          device="cuda")
    index = VectorIndex.build(vectors, encoder=RoundingEncoder(2),
                              device="cuda")
    del vectors
    src = torch.randint(0, cs.N_DOCS, (cs.N_QUERIES,), generator=gen,
                        device="cuda")
    noise = torch.randn((cs.N_QUERIES, cs.N_FEATURES), generator=gen,
                        device="cuda") * cs.NOISE
    queries = (index.vectors[src] + noise).cpu().numpy()
    index.quantized                      # the int8 table the shards view
    index.postings = None                # the shards build their own
    s42 = ShardedVectorIndex.from_index(index, mesh=make_shard_mesh(4, 2))
    return s42, s42.replica_group(0), queries


def run(idx, queries, want) -> dict:
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    cl = cs.j_cluster(idx, "fused_int8", reg)
    try:
        wall, res, lat = cs.j_drive(cl, queries, STREAMS)
        st = cl.stats()
    finally:
        cl.close()
    for (_, qi), (ids, scores) in res.items():
        if qi not in want:
            want[qi] = (ids, scores)
        cs.check(np.array_equal(ids, want[qi][0])
                 and np.array_equal(scores, want[qi][1]),
                 f"row {qi}: answers differ between variants")
    lat = np.sort(np.asarray(lat))
    return {"qps": len(lat) / wall,
            "latency_s_p50": float(lat[len(lat) // 2]),
            "dispatch_s_mean": {g: s["dispatch_latency_s"]["mean"]
                                for g, s in st["groups"].items()},
            "dispatches": sum(s["batches"]["count"]
                              for s in st["groups"].values())}


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.monotonic()
    s42, s41, queries = build()
    want = {}
    runs = {name: [] for name, _, _ in VARIANTS}
    run(s41, queries, want)                                  # warm
    for r in range(ROUNDS):
        for name, groups, ctx in VARIANTS:
            with ctx():
                runs[name].append(run(s42 if groups == 2 else s41,
                                      queries, want))
            cs.progress(f"round {r} {name}: "
                        f"{runs[name][-1]['qps']:.0f} QPS")
    traces = {}
    for name, groups, ctx in VARIANTS:
        if groups == 2:
            with ctx():
                traces[name] = cs.trace_groups(s42, queries)
    out = {"device": smi, "engine": "fused_int8", "streams": STREAMS,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "requests_per_stream": len(queries), "rounds": ROUNDS,
           "qps_median": {n: statistics.median(r["qps"] for r in rs)
                          for n, rs in runs.items()},
           "runs": runs, "traces": traces,
           "answers_bit_equal": True, "s": time.monotonic() - t0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
