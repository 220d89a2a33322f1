"""ES ``_search?profile=true``-style per-query execution profiles.

A :class:`ProfileNode` tree is the answer to *why was THIS query slow*:
one node per serving phase -- queue wait, batch formation, then the
dispatch subtree the index itself annotates (encode, phase-1, merge
select, final rescore) with per-generation child nodes carrying
candidate counts -- plus the config that shaped the work (engine, kernel
path taken, page/k, merge transport).

Collection discipline (the same contract as
:mod:`repro_torch.obs.metrics` / :mod:`repro_torch.obs.tracing`): every
timestamp is host-side, taken *around* the search dispatch.  In profile
mode the phase boundaries are fenced with ``torch.cuda.synchronize`` of
the index's device so a phase's wall time is attributable to that phase
-- a fence changes WHEN the host observes values, never the values
themselves, so answers with profiling ON are bit-identical.  Without a
profile no fence is added.

Reconciliation is part of the schema: a root's ``duration_s`` and its
top-level children derive from SHARED clock reads in the batcher (the
end of ``queue_wait`` IS the start of ``batch_form``), so the phases
tile the total exactly (float addition error only).

Entry points: ``BatchedSearchEngine.search(..., profile=True)`` /
``submit(..., profile=True)`` resolve to ``(ids, scores, profile_dict)``.
:func:`format_profile_tree` renders the dict ``_cat``-style;
:func:`profile_from_trace` derives a profile view from a finished
:class:`~repro_torch.obs.tracing.Trace` (the slow log's promotion path).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["ProfileNode", "format_profile_tree", "profile_from_trace"]


class ProfileNode:
    """One phase of a profiled request.  ``duration_s`` is host wall
    time (None for structural nodes that only carry attrs, e.g. a
    per-generation candidate-count child); ``children`` hold sub-phases,
    as nodes or already-serialized dicts (a cluster root adopts the
    engine subtree in dict form)."""

    __slots__ = ("name", "duration_s", "attrs", "children")

    def __init__(self, name: str, duration_s: Optional[float] = None,
                 **attrs):
        self.name = name
        self.duration_s = duration_s
        self.attrs = attrs
        self.children: List = []

    def child(self, name: str, duration_s: Optional[float] = None,
              **attrs) -> "ProfileNode":
        node = ProfileNode(name, duration_s, **attrs)
        self.children.append(node)
        return node

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() if isinstance(c, ProfileNode) else c
                         for c in self.children],
        }


def _fmt_attrs(attrs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in attrs.items())


def format_profile_tree(profile) -> str:
    """Render a profile dict (or node) as an indented ``_cat``-style
    tree: one line per phase with wall time, percent of the root total,
    and the phase's attrs.  Durationless structural nodes render ``-``.
    """
    if isinstance(profile, ProfileNode):
        profile = profile.to_dict()
    total = profile.get("duration_s")
    lines: List[str] = []

    def emit(node: dict, prefix: str, branch: str, kid_prefix: str):
        dur = node.get("duration_s")
        dtxt = "        -" if dur is None else f"{dur * 1e3:7.3f}ms"
        pct = ""
        if dur is not None and total:
            pct = f" {100.0 * dur / total:5.1f}%"
        attrs = _fmt_attrs(node.get("attrs", {}))
        name = str(node.get("name", "?"))
        pad = max(1, 24 - len(prefix + branch + name))
        lines.append(f"{prefix}{branch}{name}{' ' * pad}{dtxt}{pct}"
                     + (f"  {attrs}" if attrs else ""))
        kids = node.get("children", [])
        for i, c in enumerate(kids):
            last = i == len(kids) - 1
            emit(c, kid_prefix, "`- " if last else "|- ",
                 kid_prefix + ("   " if last else "|  "))

    emit(profile, "", "", "")
    return "\n".join(lines)


def profile_from_trace(trace: dict) -> dict:
    """A profile tree derived from a finished trace dict (the slow log's
    promotion path: every request carries a span skeleton, and a slow or
    failed one is promoted to this view).  Spans become phase children;
    span events become durationless grandchildren, so a failover's
    spill/resubmit history survives into the rendered tree."""
    root = ProfileNode(trace.get("name", "query"), **trace.get("attrs", {}))
    t0, t1 = trace.get("t0"), trace.get("t1")
    if t0 is not None and t1 is not None:
        root.duration_s = t1 - t0
    for s in trace.get("spans", ()):
        node = root.child(s["name"], s.get("duration_s"),
                          **s.get("attrs", {}))
        for ev in s.get("events", ()):
            node.child(f"event:{ev['name']}", **ev.get("attrs", {}))
    return root.to_dict()
