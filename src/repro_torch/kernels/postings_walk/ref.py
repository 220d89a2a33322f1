"""Plain PyTorch version of the posting walk.

The kept ranges are expanded a run of columns at a time, near
``_STEP_ENTRIES`` entries a run, into the flat position of every entry
over (C, d), its target ``q * d + doc`` and its weight, and added into a
dense accumulator by one ``index_add_`` round a column, in increasing
column order.  A doc sits in one posting list a column, so a round adds
at most once to an address, and every (query, doc) is summed from +0.0 in
column order: the kernel's bits, and on the CPU the JAX package's
``segment_sum``'s.  One host read of the entry and token counts per column
cuts the runs.
"""

from __future__ import annotations

import torch

__all__ = ["postings_walk_ref"]

# posting entries gathered per step (about 36 bytes each while a step's
# rounds run)
_STEP_ENTRIES = 1 << 25


def postings_walk_ref(
    post_docs: torch.Tensor,    # (C, d) int32
    lo: torch.Tensor,           # (Q, C) int64 range starts
    hi: torch.Tensor,           # (Q, C) int64 range ends, <= lo if not walked
    w: torch.Tensor,            # (Q, C) f32
) -> torch.Tensor:
    """(Q, d) f32 scores of the ranges ``[lo, hi)``, each token's weight
    added at the docs of its range."""
    C, d = post_docs.shape
    Q = lo.shape[0]
    dev = lo.device
    # the walked tokens in column-major order: column, then query
    kc, kq = (hi > lo).T.nonzero(as_tuple=True)
    lengths = (hi - lo)[kq, kc]
    starts = kc * d + lo[kq, kc]
    w = w[kq, kc]
    per_col = torch.zeros((2, C), dtype=torch.int64, device=dev)
    per_col[0].index_add_(0, kc, lengths)                   # entries
    per_col[1].index_add_(0, kc, torch.ones_like(kc))       # tokens
    entries, tokens = per_col.tolist()
    scores = torch.zeros((Q * d,), dtype=torch.float32, device=dev)
    post_docs = post_docs.reshape(-1)
    c = t0 = 0
    while c < C:
        c1, n = c + 1, entries[c]                   # a run of columns
        while c1 < C and n + entries[c1] <= _STEP_ENTRIES:
            n += entries[c1]
            c1 += 1
        t1 = t0 + sum(tokens[c:c1])
        if n:
            ln = lengths[t0:t1]
            # every kept posting position of the run, flat over (C, d):
            # starts repeated per entry plus the entry's offset in its range
            first = torch.repeat_interleave(torch.cumsum(ln, 0) - ln, ln,
                                            output_size=n)
            pos = torch.repeat_interleave(starts[t0:t1], ln, output_size=n)
            pos += torch.arange(n, device=dev) - first
            del first
            target = torch.repeat_interleave(kq[t0:t1] * d, ln,
                                             output_size=n)
            target += post_docs[pos]
            del pos
            vals = torch.repeat_interleave(w[t0:t1], ln, output_size=n)
            o = 0
            for m in entries[c:c1]:         # one round per column
                if m:
                    scores.index_add_(0, target[o:o + m], vals[o:o + m])
                    o += m
            del target, vals
        c, t0 = c1, t1
    return scores.view(Q, d)
