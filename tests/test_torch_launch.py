"""repro_torch's serving launcher (``python -m repro_torch.launch.serve``)
against the JAX package's (``python -m repro.launch.serve``), on the CPU.

* **the same answer on the same inputs** -- the randomized SVD cannot
  share the JAX package's random draws, so the port's launcher is run
  (in a subprocess) on the reference's LSA vectors, carried across as
  numpy: it serves the reference launcher's ids against its gold ids,
  bit for bit, so its P@10 is the reference's exactly, and the digest it
  prints is that of those ids; on its own LSA it prints the reference's
  lines, numbers aside, plus two of its own: the served ids' digest and
  the kernel launches;
* **the same argument checks** -- every refused combination exits 2 with
  the reference's message, the reference's run in one subprocess;
* **the operator's smoke runs** -- the argument sets of the Makefile's
  ``smoke-store``, ``smoke-obs`` (healthy and with a failed group),
  ``smoke-profile`` and ``smoke-health`` targets run on the CPU through
  the port's launcher, exit 0 with their own assertions (failover and
  recovery bit-identical, counters, trees and slow log reconciled, no
  steady-state build), and ``tools/validate_diag_bundle_torch.py``
  accepts smoke-health's bundles.  S doc-shards hold S pages of
  candidates, so a sharded run's P@10 is at least the flat run's, and
  runs with the same shard count print the same P@10 (replica groups
  are copies).  The reference's sharded launcher cannot run on this
  JAX, so it is no oracle there.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core.search import ENGINES

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--docs", "1500", "--features", "64", "--queries", "24",
         "--batch-size", "8"]
SMOKE = ["--docs", "2000", "--features", "32", "--queries", "32"]
TIMEOUT = 600


def _env():
    # one intra-op thread a launcher: the suite's other workers share the
    # host's cores
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _run(argv, module="repro_torch.launch.serve", code=None):
    cmd = ([sys.executable, "-c", code, *argv] if code is not None
           else [sys.executable, "-m", module, *argv])
    return subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          cwd=_REPO, timeout=TIMEOUT)


def _p10(out: str) -> float:
    return float(re.search(r"P@10 vs brute force: ([0-9.]+)", out).group(1))


def _shape(out: str):
    """The printed lines with every number masked."""
    return [re.sub(r"[0-9]+(\.[0-9]+)?", "#", ln) for ln in out.splitlines()]


# both launchers' ``precision_at_k`` patched to save what it is handed:
# the served ids and the gold ids of the first pass
_CAPTURE = r"""
import sys
import numpy as np

def capturing(module):
    real = module.precision_at_k
    ids_path, gold_path = sys.argv[1], sys.argv[2]

    def precision_at_k(ids, gold):
        np.save(ids_path, np.asarray(ids))
        np.save(gold_path, np.asarray(gold))
        module.precision_at_k = real              # the first pass only
        return real(ids, gold)
    module.precision_at_k = precision_at_k
"""

_REF_CAPTURED = _CAPTURE + r"""
from repro.launch import serve
capturing(serve)
sys.argv = ["serve", *sys.argv[3:]]
serve.main()
"""

_PORT_CARRIED = _CAPTURE + r"""
import torch
from repro.data import make_corpus
from repro.lsa import build_lsa
from repro_torch.launch import serve

class Pipe:
    pass

def carried_lsa(corpus, n_features, device):
    # the reference launcher's corpus and LSA, its vectors as numpy
    ref = build_lsa(make_corpus(n_docs=corpus.doc_terms.shape[0],
                                vocab_size=corpus.vocab_size, n_topics=64,
                                seed=0), n_features=n_features)
    pipe = Pipe()
    pipe.doc_vectors = torch.from_numpy(np.asarray(ref.doc_vectors)).to(
        device)
    return pipe

serve.build_lsa = carried_lsa
capturing(serve)
serve.main(sys.argv[3:])
"""


def _captured(tmp_path, name, code, argv):
    ids, gold = tmp_path / f"{name}_ids.npy", tmp_path / f"{name}_gold.npy"
    run = _run([str(ids), str(gold), *argv], code=code)
    assert run.returncode == 0, run.stdout + run.stderr
    return run.stdout, np.load(ids), np.load(gold)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    return _captured(tmp_path_factory.mktemp("ref"), "ref", _REF_CAPTURED,
                     SMALL)


def _hits(ids, gold) -> int:
    return sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                   gold.tolist()))


def test_p10_equals_reference_on_the_reference_lsa(reference_run, tmp_path):
    """On the reference's LSA vectors the port's launcher serves the same
    ids against the same gold ids: the same P@10, exactly (the printed
    value is a float32 mean, whose last printed digit may round apart)."""
    ref_out, ref_ids, ref_gold = reference_run
    out, ids, gold = _captured(tmp_path, "port", _PORT_CARRIED,
                               [*SMALL, "--device", "cpu"])
    assert np.array_equal(gold, ref_gold)
    assert np.array_equal(ids, ref_ids)
    hits = _hits(ids, gold)
    assert hits == _hits(ref_ids, ref_gold)
    assert abs(_p10(out) - hits / ids.size) <= 5e-4
    assert abs(_p10(ref_out) - hits / ids.size) <= 5e-4 + 1e-6
    digest = hashlib.sha256(np.ascontiguousarray(
        ids.astype(np.int64)).tobytes()).hexdigest()
    assert f"served ids sha256: {digest}" in out.splitlines()


def test_prints_the_reference_lines(reference_run):
    run = _run([*SMALL, "--device", "cpu"])
    assert run.returncode == 0, run.stdout + run.stderr
    lines = _shape(run.stdout)
    assert lines[:-2] == _shape(reference_run[0])
    assert re.fullmatch(r"served ids sha256: [0-9a-f]{64}",
                        run.stdout.splitlines()[-2])
    launches = json.loads(run.stdout.splitlines()[-1].split(": ", 1)[1])
    assert launches == dict.fromkeys(
        ("fused_phase1", "fused_phase1_quant", "code_match", "bucketize",
         "rerank_topk", "postings_walk", "page_select"),
        0)  # the CPU runs the plain ones


# the refused combinations, each with the start of the reference's message
REFUSED = [
    (["--replicas", "2"], "--replicas needs --shards >= 1"),
    (["--merge", "stream"], "--merge needs --shards >= 1"),
    (["--ingest", "10"], "--ingest needs --shards >= 1"),
    (["--shards", "2", "--ingest", "1500"], "--ingest must be in [0, --docs)"),
    (["--cluster"], "--cluster needs --shards >= 1"),
    (["--shards", "2", "--cluster", "--fail-shard", "0"],
     "--fail-shard needs --cluster and --replicas >= 2"),
    (["--shards", "2", "--replicas", "2", "--cluster", "--fail-shard", "2"],
     "--fail-shard must be in [0, 2)"),
    (["--shards", "2", "--auto-compact", "0.2"],
     "--auto-compact needs --cluster"),
    (["--store", "x"], "--store needs --shards >= 1"),
    (["--durability", "async"], "--durability needs --store"),
    (["--kill-and-recover"], "--kill-and-recover needs --store"),
    (["--stats-interval", "0"], "--stats-interval must be positive"),
    (["--slow-threshold", "-1"], "--slow-threshold must be >= 0"),
    (["--shards", "2", "--cluster", "--auto-compact", "0.2",
      "--fail-on-recompile"], "--fail-on-recompile is incompatible with "
                              "--auto-compact"),
    (["--shards", "2", "--store", "x", "--kill-and-recover",
      "--fail-on-recompile"], "--fail-on-recompile is incompatible with "
                              "--kill-and-recover"),
]

_REF_REFUSALS = r"""
import contextlib, io, json, sys
from repro.launch import serve
cases = json.loads(sys.argv[1])
out = []
for argv in cases:
    err = io.StringIO()
    sys.argv = ["serve", "--docs", "1500", *argv]
    with contextlib.redirect_stderr(err):
        try:
            serve.main()
            code = 0
        except SystemExit as exc:
            code = exc.code
    out.append([code, err.getvalue()])
print("JSON" + json.dumps(out))
"""


def test_argument_checks_match_reference():
    from repro_torch.launch import serve

    run = _run([json.dumps([argv for argv, _ in REFUSED])],
               code=_REF_REFUSALS)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("JSON")]
    assert line, run.stdout + run.stderr
    ref = json.loads(line[0][4:])
    for (argv, msg), (ref_code, ref_err) in zip(REFUSED, ref):
        ap = serve._parser()
        args = ap.parse_args(["--docs", "1500", *argv])
        err = []
        ap.error = lambda m: (err.append(m), sys.exit(2))
        with pytest.raises(SystemExit) as exc:
            serve._check_args(ap, args)
        assert exc.value.code == ref_code == 2, argv
        assert err[0].startswith(msg), (argv, err)
        assert f"error: {err[0]}" in ref_err, (argv, ref_err)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_choices_are_the_engine_table(engine):
    """``--engine`` offers the engine table's names in its order, with
    ``codes`` the default, and each parses."""
    from repro_torch.launch import serve

    ap = serve._parser()
    (action,) = [a for a in ap._actions if a.dest == "engine"]
    assert list(action.choices) == list(ENGINES)
    assert action.default == "codes"
    assert ap.parse_args(["--engine", engine]).engine == engine


# ----------------------------------------------------------- smoke runs
@pytest.fixture(scope="module")
def flat_p10():
    run = _run([*SMOKE, "--device", "cpu"])
    assert run.returncode == 0, run.stdout + run.stderr
    return _p10(run.stdout)


SMOKE_RUNS = {
    "smoke-store": ["--shards", "4", "--ingest", "200", "--store", "{tmp}/st",
                    "--kill-and-recover"],
    "smoke-obs": ["--shards", "2", "--replicas", "2", "--cluster",
                  "--stats-interval", "0.5"],
    "smoke-obs-fail": ["--shards", "2", "--replicas", "2", "--cluster",
                       "--fail-shard", "0", "--stats-interval", "0.5"],
    "smoke-profile": ["--shards", "2", "--replicas", "2", "--cluster",
                      "--stats-interval", "0.5", "--profile",
                      "--slow-threshold", "0", "--fail-on-recompile",
                      "--metrics-file", "{tmp}/metrics.jsonl"],
    "smoke-health": ["--shards", "4", "--replicas", "2", "--cluster",
                     "--fail-shard", "0", "--stats-interval", "0.5",
                     "--slow-threshold", "0", "--diagnostics-on-exit",
                     "{tmp}/diag"],
}

# what each run prints once its own assertions passed
SMOKE_LINES = {
    "smoke-store": ["kill-and-recover: crash-recovered 2000 docs",
                    "search results BIT-IDENTICAL"],
    "smoke-obs": ["stats: counters reconcile with the 32 queries issued"],
    "smoke-obs-fail": ["results bit-identical to the healthy cluster",
                       "stats: counters reconcile with the 64 queries"],
    "smoke-profile": ["phases tile each total exactly",
                      "slowlog: tail capture reconciles",
                      "recompile watch: zero steady-state recompiles",
                      "metrics: 2 snapshot(s)"],
    "smoke-health": ["(transitions reconcile: green -> yellow -> green",
                     "diagnostics bundle (failover)",
                     "diagnostics bundle (exit)"],
}

_SHARD_P10 = {}


@pytest.mark.parametrize("name", list(SMOKE_RUNS))
def test_smoke_runs_on_cpu(name, flat_p10, tmp_path):
    argv = [a.format(tmp=tmp_path) for a in SMOKE_RUNS[name]]
    run = _run([*SMOKE, *argv, "--device", "cpu"])
    assert run.returncode == 0, run.stdout + run.stderr
    for text in SMOKE_LINES[name]:
        assert text in run.stdout, (text, run.stdout)
    p10 = _p10(run.stdout)
    assert p10 >= flat_p10
    shards = argv[argv.index("--shards") + 1]
    assert _SHARD_P10.setdefault(shards, p10) == p10, (shards, _SHARD_P10)
    if name == "smoke-health":
        out = subprocess.run(
            [sys.executable, os.path.join(_REPO, "tools",
                                          "validate_diag_bundle_torch.py"),
             str(tmp_path / "diag")], capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "OK (2 bundle(s)" in out.stdout
    if name == "smoke-profile":
        lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
        assert len(lines) == 2 and all(json.loads(ln)["metrics"]
                                       for ln in lines)


def _digest(out: str) -> str:
    return re.search(r"^served ids sha256: ([0-9a-f]{64})$", out,
                     re.M).group(1)


def test_engines_and_layouts_serve_the_same_ids():
    """``codes``, ``codes_pallas`` and ``fused`` (4 x 2, ``stream``) on
    one corpus print one digest of the first pass's ids: the kernels'
    engines score what the composed one scores, at any layout, as
    ``chip_smoke.py``'s phase K holds them on the card."""
    digests = {}
    for extra in (["--engine", "codes"], ["--engine", "codes_pallas"],
                  ["--engine", "fused", "--replicas", "2", "--merge",
                   "stream"]):
        run = _run([*SMOKE, "--shards", "4", "--cluster", *extra,
                    "--device", "cpu"])
        assert run.returncode == 0, run.stdout + run.stderr
        digests[" ".join(extra)] = (_digest(run.stdout), _p10(run.stdout))
    assert len(set(digests.values())) == 1, digests


def test_store_refuses_a_used_directory(tmp_path):
    argv = [*SMOKE, "--docs", "300", "--shards", "2", "--store",
            str(tmp_path / "st"), "--device", "cpu"]
    assert _run(argv).returncode == 0
    run = _run(argv)
    assert run.returncode == 2
    assert "already holds a commit point" in run.stderr
