"""Find an open-loop cell's knee: the highest offered rate at which the
backlog does not grow through the window.  Runs the cell at each rate in
turn in one process, on the card, and prints one JSON line a rate: the
offered and answered rates, the median latency of the window's first and
last fifth of queries, and whether the backlog grew (the last fifth's
median over twice the first's, or fewer than 97% of the offered queries
answered in the window).

    python3 portbench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 600,800,1000
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build"
                                              / "repro_torch_kernels")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.run_cell import execute

    if not torch.cuda.is_available():
        print("portbench sweep: no CUDA card", file=sys.stderr)
        return 2
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        out = execute(args.workload, args.seed + i, args.seconds, False,
                      root=ROOT, overrides={"mix": {"rate_qps": rate}})
        run = out["run"]
        n = run.n_window
        lat = (run.rec.done[:n] - run.rec.due[:n]) * 1e3
        fifth = max(1, n // 5)
        first = float(np.nanmedian(lat[:fifth]))
        last = float(np.nanmedian(lat[-fifth:]))
        grew = bool(last > 2 * first or run.qps < 0.97 * rate)
        print(json.dumps({"rate_qps": rate, "qps": run.qps,
                          "p50_first_ms": first, "p50_last_ms": last,
                          "grew": grew,
                          "correct": out["result"]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
