#!/usr/bin/env python3
"""Validate diagnostics bundles written by the PyTorch port's launcher.

    python3 tools/validate_diag_bundle_torch.py DIR

Given a directory of ``diagnostics-*.json`` files written by
``python -m repro_torch.launch.serve --diagnostics-on-exit DIR`` (or by
``repro_torch.obs.write_diagnostics``), assert that:

* at least one bundle exists, and one has reason ``exit`` (the
  end-of-run dump);
* every bundle parses as JSON and contains EVERY documented section key
  (``BUNDLE_SECTIONS`` is loaded from
  ``src/repro_torch/obs/diagnostics.py`` itself, so this check can never
  drift from the writer);
* the load-bearing sections are populated: stats counted requests,
  health reports a status, the device table holds bytes, and a
  ``failover`` bundle's health section shows the down group the
  incident injected.

The checks of ``tools/validate_diag_bundle.py``, for the port's bundles.
Pure stdlib plus one by-path module load (no torch, no jax import): the
validator runs anywhere the JSON can.  Exit 0 when every bundle passes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bundle_sections():
    """Load BUNDLE_SECTIONS straight from the module file -- not through
    the package, whose __init__ would pull in torch."""
    path = os.path.join(_ROOT, "src", "repro_torch", "obs", "diagnostics.py")
    spec = importlib.util.spec_from_file_location("_diag", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple(mod.BUNDLE_SECTIONS)


def validate(directory: str) -> int:
    sections = _bundle_sections()
    files = sorted(fn for fn in os.listdir(directory)
                   if fn.startswith("diagnostics-") and fn.endswith(".json"))
    if not files:
        print(f"validate_diag_bundle_torch: no bundles in {directory}",
              file=sys.stderr)
        return 1
    failures = []
    reasons = []
    for fn in files:
        path = os.path.join(directory, fn)
        try:
            with open(path) as f:
                b = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            failures.append(f"{fn}: unparseable: {exc}")
            continue
        missing = [s for s in sections if s not in b]
        if missing:
            failures.append(f"{fn}: missing section(s) {missing}")
            continue
        reason = (b["meta"] or {}).get("reason")
        reasons.append(reason)
        if not b["stats"] or b["stats"]["requests"]["completed"] < 1:
            failures.append(f"{fn}: stats section has no completed requests")
        if b["health"] is not None and "status" not in b["health"]:
            failures.append(f"{fn}: health section has no status")
        dev = b["device"] or {}
        if not any(d.get("total_bytes", 0) > 0 for d in dev.values()):
            failures.append(f"{fn}: device table holds no bytes")
        if reason == "failover":
            h = b["health"] or {}
            if h.get("status") != "yellow" or not h.get("down"):
                failures.append(
                    f"{fn}: failover bundle should capture the yellow "
                    f"mid-incident state, got {h.get('status')!r} "
                    f"down={h.get('down')!r}")
        print(f"validate_diag_bundle_torch: {fn}: reason={reason} "
              f"sections={len(sections)} ok")
    if "exit" not in reasons:
        failures.append("no bundle with reason=exit (the end-of-run dump)")
    if failures:
        for msg in failures:
            print(f"validate_diag_bundle_torch: FAIL {msg}", file=sys.stderr)
        return 1
    print(f"validate_diag_bundle_torch: OK ({len(files)} bundle(s), every "
          f"section present: {', '.join(sections)})")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__.splitlines()[2].strip(), file=sys.stderr)
        sys.exit(2)
    sys.exit(validate(sys.argv[1]))
