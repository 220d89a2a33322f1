"""The port's benchmark: one cell of ``BENCHMARK.json`` on one process.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell's system from its configuration file with ``repro_torch``
(the PyTorch and CUDA package under ``src/``), drives the cell's traffic
for ``--seconds``, checks a sample of the answers against the plain
reference in ``portbench/reference/``, and prints one JSON line last on
standard output: the end-to-end metrics with ``--trace 0``, the
per-layer metrics and the device trace's summary with ``--trace 1``.
The numbers compared and their limits are the last lines on standard
error.  It exits with 2 and prints no result without a CUDA card, without
the program, or if JAX or the JAX package was loaded.  Every build cache
lives under ``build/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where there is
    none)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    age = _process_age()
    t_age = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        return _fail(f"the program is not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness.run_cell import execute
    from portbench.harness.spec import Spec

    spec = Spec(args.workload, ROOT)
    if not torch.cuda.is_available():
        return _fail("no CUDA card: the benchmark runs only on one")
    if torch.cuda.device_count() < spec.chips:
        return _fail(f"the cell needs {spec.chips} cards, "
                     f"{torch.cuda.device_count()} present")
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  root=ROOT, device="cuda", setup_t0=t_age,
                  setup_offset=age)
    return emit(out)


def emit(out: dict) -> int:
    """Print a finished run: its set-up parts and the numbers compared on
    standard error, then the result line, last on standard output.  The
    look for JAX comes first, after everything the run loaded (the
    reference and the metric readers too); if it finds any, it exits with
    2 and prints no result."""
    from portbench.harness.run_cell import forbidden_modules

    bad = forbidden_modules()
    if bad:
        return _fail("modules of JAX or of the JAX package were loaded: "
                     + ", ".join(bad))
    print("setup parts (s): " + json.dumps(out["setup_parts"]),
          file=sys.stderr)
    for key, (value, limit) in out["checks"].items():
        print(f"check {key}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
