"""Nothing the benchmark runs loads JAX or the JAX package, and nothing
of it reads the JAX package's benchmark folders."""

from __future__ import annotations

import os
import re
import subprocess
import sys

from portbench.harness.spec import BENCH_DIR, ROOT

_PROBE = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
from portbench.harness.spec import load_reader
bench = root / "portbench"
for path in sorted(bench.rglob("*.py")):
    rel = path.relative_to(root)
    if path.name.startswith("test_") or path.name == "conftest.py":
        continue
    if path.parent.name == "metrics":
        load_reader(path)
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts))
from portbench import run
from portbench.harness import data
from portbench.harness.spec import load_json
from portbench.harness.system import System
for cfg_path in sorted((bench / "configs").glob("*.json")):
    cfg = load_json(cfg_path)
    g = data.generator(1, "cpu")
    base = data.unit_rows(256, cfg["corpus"]["features"], g, "cpu", 2,
                          cfg.get("trim"), 2e-6)
    System(dict(cfg, page=16), base, "cpu").close()
rc = run.main(["--workload", "wiki-fused-open", "--seed", "1",
               "--seconds", "1", "--trace", "0"])
import torch
want = 0 if torch.cuda.is_available() else 2
bad = sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "repro"})
print("RC", rc, want, "BAD", ",".join(bad))
"""


def test_portbench_loads_no_jax_and_no_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RC ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-2000:]
    _, rc, want, _, bad = (line[-1].split(" ") + [""])[:5]
    if want == "2":
        assert rc == "2"
    assert bad == "", f"loaded: {bad}"


def test_portbench_reads_nothing_of_the_jax_benchmarks():
    pat = re.compile(r"""["'/](benchmarks|artifacts)(/|["'])""")
    me = os.path.basename(__file__)
    for path in BENCH_DIR.rglob("*"):
        if path.is_dir() or path.name == me or "__pycache__" in path.parts:
            continue
        text = path.read_text(errors="replace")
        assert not pat.search(text), f"{path} names the JAX package's files"
