"""The plain reference against the port's own answers, at a small size on
the CPU (and, marked ``cuda``, on the card): the reference agrees with a
sound program, and the comparison fails the control and each planted
fault."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.harness.run_cell import execute
from portbench.harness.spec import BENCH_DIR
from portbench.reference.search_ref import Layout, Reference

N, NF, PAGE, K = 3000, 64, 64, 10


def _limits(config: str) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    return cfg["check"]["limits"]


def _rows(seed: int, n: int, device="cpu"):
    g = data.generator(seed, device)
    return data.unit_rows(n, NF, g, device, 2, 0.05, 2e-6), g


def _queries(base, g, n: int):
    src = torch.randint(0, base.shape[0], (n,), generator=g,
                        device=base.device)
    return data.noisy_copies(base[src], 0.01, g, 2, 0.05, 2e-6)


def _flat(device):
    from repro_torch.core import TrimFilter
    from repro_torch.core.search import VectorIndex

    base, g = _rows(11, N, device)
    q = _queries(base, g, 40)
    idx = VectorIndex.build(base, device=device)
    ids, scores = idx.search(q, k=K, page=PAGE, trim=TrimFilter(0.05),
                             engine="fused")
    ref = Reference(Layout("codes", 1, PAGE, K, 2, 0.05, 1e-4), base)
    return ref, q, ids.cpu().numpy(), scores.cpu().numpy()


def _sharded(device):
    from repro_torch.core.search import VectorIndex
    from repro_torch.launch.mesh import make_shard_mesh

    base, g = _rows(12, N + 2, device)       # a ragged last shard
    bulks = [data.unit_rows(64, NF, g, device, 2, 0.05, 2e-6)
             for _ in range(3)]
    vi = VectorIndex.build(base, device=device)
    vi.quantized
    idx = vi.shard(make_shard_mesh(4, 1, device=device), seal_threshold=32)
    for b in bulks:
        idx = idx.add_documents(b)
    idx = idx.merge_segments(0, 2)
    q = torch.cat([_queries(base, g, 24), _queries(bulks[2], g, 8)])
    ids, scores = idx.search(q, k=K, page=PAGE, engine="fused_int8")
    ref = Reference(Layout("int8", 4, PAGE, K, 2, 0.05, 1e-2), base, bulks)
    return ref, q, ids.cpu().numpy(), scores.cpu().numpy(), idx


def test_portbench_reference_agrees_with_the_fused_index():
    ref, q, ids, scores = _flat("cpu")
    got = ref.judge(q, ids, scores)
    assert got["rank_gap"] == pytest.approx(0.0, abs=1e-12)
    assert got["page_shortfall"] == 0.0
    assert got["score_err"] < 1e-6


def test_portbench_reference_agrees_with_the_sharded_int8_index_after_ingest():
    ref, q, ids, scores, idx = _sharded("cpu")
    n = np.full(len(q), 3)
    got = ref.judge(q, ids, scores, n, n)
    assert got["rank_gap"] == pytest.approx(0.0, abs=1e-12)
    assert got["page_shortfall"] == 0.0
    assert got["score_err"] < 1e-6
    # the layout rule the reference assumes: appended id g on shard
    # (g - N) % S, through seals and a merge
    for seg in idx.segments:
        gids = seg.gids.cpu().numpy()
        for s in range(4):
            own = gids[s][gids[s] >= 0]
            assert np.all((own - (N + 2)) % 4 == s)
    # a query that did not see the last bulk fails where it needed it:
    # its answers copy rows of that bulk
    fewer = np.full(len(q), 2)
    assert ref.judge(q[-8:], ids[-8:], scores[-8:], fewer[-8:],
                     fewer[-8:])["page_shortfall"] == 1.0
    # ... and passes where the bulk was being written when it was sent
    assert ref.judge(q[-8:], ids[-8:], scores[-8:], fewer[-8:],
                     n[-8:])["rank_gap"] == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("config,make", [("wiki-lsa400-fused", _flat),
                                         ("wiki-lsa400-4x2-int8", _sharded)])
def test_portbench_reference_control_reads_above_the_limit(config, make):
    ref, q, *_ = make("cpu")
    lim = _limits(config)
    n = np.full(len(q), len(ref.bulk_sizes))
    ids, scores = ref.control_answers(q, n, tf32=True)
    ctl = ref.judge(q, ids, scores, n, n)
    assert ctl["score_err"] > lim["score_err"]
    ids, scores = ref.control_answers(q, n, tf32=False)
    full = ref.judge(q, ids, scores, n, n)
    assert all(full[key] <= lim[key] for key in lim)


@pytest.mark.parametrize("config,make", [("wiki-lsa400-fused", _flat),
                                         ("wiki-lsa400-4x2-int8", _sharded)])
def test_portbench_reference_phase1_bf16_control_moves_the_pages(config,
                                                                 make):
    ref, q, *_ = make("cpu")
    lim = _limits(config)
    n = np.full(len(q), len(ref.bulk_sizes))
    exact, low = ref._scored(q[:32]), ref._scored(q[:32], phase1_bf16=True)
    moved = sum(len(set(a[1][i]) ^ set(b[1][i]))
                for a, b in zip(exact[3], low[3]) for i in range(32))
    assert moved > 0
    ids, scores = ref.control_answers(q, n, tf32=False, phase1_bf16=True)
    got = ref.judge(q, ids, scores, n, n)
    if config == "wiki-lsa400-fused":
        # bfloat16 idf weights reorder tied token matches: answers move
        assert got["rank_gap"] > lim["rank_gap"]


_TINY = {"config": {"corpus": {"docs": 2048, "features": NF}, "page": 32,
                    "batcher": {"batch_size": 8}, "check": {"judged": 24}},
         "mix": {"rate_qps": 120.0, "pool": 2048, "sessions": 24}}


def _tiny(workload: str) -> dict:
    ov = json.loads(json.dumps(_TINY))
    if "ingest" in workload:
        ov["mix"]["writes"] = {"rows": 64, "period_s": 0.3, "start_s": 0.1}
    return ov


@pytest.mark.parametrize("workload,fault", [
    ("wiki-fused-open", "none"),
    ("wiki-fused-open", "answer_altered"),
    ("wiki-fused-open", "half_batch"),
    ("wiki4x2-int8-closed", "none"),
    ("wiki4x2-int8-closed", "half_batch"),
    ("wiki4x2-int8-closed", "exchange_left_out"),
    ("wiki4x2-int8-ingest", "none"),
    ("wiki4x2-int8-ingest", "answer_altered"),
])
def test_portbench_a_run_with_a_broken_path_is_not_correct(workload, fault):
    out = execute(workload, 20240501 + len(fault), 0.8, False,
                  device="cpu", overrides=_tiny(workload), fault=fault)
    res = out["result"]
    assert res["correct"] is (fault == "none"), res["checks"]
    assert res["attempted"] > 0 and list(res)[-1] == "checks"


@pytest.mark.cuda
def test_portbench_reference_agrees_with_the_port_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, q, ids, scores = _flat("cuda")
    got = ref.judge(q, ids, scores)
    assert got["rank_gap"] < 1e-12 and got["page_shortfall"] == 0.0
    assert got["score_err"] < 1e-6
    ref, q, ids, scores, _ = _sharded("cuda")
    n = np.full(len(q), 3)
    got = ref.judge(q, ids, scores, n, n)
    assert got["rank_gap"] < 1e-12 and got["page_shortfall"] < 1e-3
    assert got["score_err"] < 1e-6
