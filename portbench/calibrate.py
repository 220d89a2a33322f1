"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size, in one process:

* the program's numbers on each seed (a short window at the cell's own
  load; the lower readings);
* the control's on the same judged queries: the reference put in the
  program's place with its rescore in TF32, the precision below the
  configuration's float32 (the upper readings); and the reference with
  its phase 1's query side in bfloat16, with the share of answers that
  this changes;
* each planted fault's numbers on its seeds (``harness/faults.py``).

Prints one JSON line a reading.  The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--faults answer_altered,half_batch --fault-seeds 7,8,9]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def _same_as(ref, q, n_req, ids) -> float:
    """Share of the queries whose ids equal the float32 reference's."""
    want, _ = ref.control_answers(q, n_req, tf32=False)
    return float((want == ids).all(axis=1).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build"
                                              / "repro_torch_kernels")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.run_cell import execute

    if not torch.cuda.is_available():
        print("portbench calibrate: no CUDA card", file=sys.stderr)
        return 2

    def emit(line):
        print(json.dumps(line), flush=True)

    for seed in _ints(args.seeds):
        t = time.monotonic()
        out = execute(args.workload, seed, args.seconds, False, root=ROOT)
        nums = {k: v for k, (v, _) in out["checks"].items()}
        emit({"kind": "program", "seed": seed, "numbers": nums,
              "correct": out["result"]["correct"],
              "attempted": out["result"]["attempted"],
              "setup_parts": out["setup_parts"],
              "seconds": time.monotonic() - t})
        if not args.no_control:
            ref = out["reference"]
            q, n_req, _ = out["judged"]
            ids, scores = ref.control_answers(q, n_req)
            emit({"kind": "control_tf32", "seed": seed,
                  "numbers": ref.judge(q, ids, scores, n_req, n_req)})
            ids, scores = ref.control_answers(q, n_req, tf32=False)
            emit({"kind": "reference_fp32", "seed": seed,
                  "numbers": ref.judge(q, ids, scores, n_req, n_req)})
            ids, scores = ref.control_answers(q, n_req, tf32=False,
                                              phase1_bf16=True)
            emit({"kind": "control_phase1_bf16", "seed": seed,
                  "numbers": ref.judge(q, ids, scores, n_req, n_req),
                  "answers_as_reference": _same_as(ref, q, n_req, ids)})
        del out
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in _ints(args.fault_seeds):
            out = execute(args.workload, seed, args.seconds, False,
                          root=ROOT, fault=fault)
            emit({"kind": fault, "seed": seed,
                  "numbers": {k: v for k, (v, _) in out["checks"].items()},
                  "correct": out["result"]["correct"]})
            del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
