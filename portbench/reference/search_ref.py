"""Plain reference of the paper's two-phase search, and the comparison
that decides whether a run's answers are correct.

Written from the semantics alone, in float64 where the program uses
float32, with nothing of the program imported or taken:

* encode: ``RoundingEncoder(p)``: ``round(x * 10**p)`` half away from
  zero, on the unit-normalised float32 vectors;
* trim: a query feature is kept where ``|x| >= threshold``;
* ``codes`` phase 1 (the ``fused`` engine): a document scores the sum of
  the idf weights ``ln(1 + (N - df + 0.5) / (df + 0.5))`` of the kept
  query tokens (column, bucket) it shares, with ``df`` counted over the
  corpus;
* ``int8`` phase 1 (the ``fused_int8`` engine): each row quantised to
  int8 by ``zero = (max + min) / 2``, ``scale = (max - min) / 254``,
  ``code = clip(round((v - zero) / scale), -127, 127)``, and scored as the
  dot product of the query with the dequantised row;
* every doc-shard keeps its top ``page`` by phase-1 score, and the answer
  is the top ``k`` of the union of the pages by exact cosine.

The layout is the configuration's: the base rows split into ``S``
contiguous shards of ``ceil(N / S)`` rows, and appended rows go round
robin, the row with global id ``g >= N`` to shard ``(g - N) % S``.  With
bulks whose size is a multiple of ``S`` a segment merge keeps every row
on its shard, so the layout does not depend on when merges ran.

A float32 program and this float64 reference may order two documents
differently where their phase-1 scores lie within rounding of each other.
So a shard's page is judged with a band: ``t`` is the ``page``-th score
of the shard, and with ``eps = band_rel * |t|`` a document above
``t + eps`` is surely in the page, one below ``t - eps`` surely not.  For
a query sent while a bulk was being written, that bulk may or may not be
visible: the state ``A`` holds the bulks acknowledged before the query
was sent, ``B`` those begun; the band takes the threshold of ``A`` from
below and that of ``B`` from above.

Three numbers are compared, each the largest over the judged queries:

``score_err``
    how far a reported score lies from the float64 cosine of the
    document it reports;
``rank_gap``
    how far the i-th best float64 cosine among the reported documents
    lies below the i-th best among the documents surely in some page
    (a missing, repeated or unknown id counts as cosine -1);
``page_shortfall``
    how far below its shard's page threshold (as a share of the
    threshold) the phase-1 score of a reported document lies; an id that
    no state could show reads 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Layout", "normalize32", "unit64", "rounding_codes", "trim_mask",
           "quantize32", "Reference", "tf32_round", "NUMBERS"]

NUMBERS = ("score_err", "rank_gap", "page_shortfall")

_ROWS = 1 << 17          # rows a block when scoring the corpus
_QCHUNK = 32             # judged queries scored together


def normalize32(x: torch.Tensor) -> torch.Tensor:
    """Unit rows in float32."""
    x = x.to(torch.float32)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def unit64(x: torch.Tensor) -> torch.Tensor:
    """Unit rows in float64."""
    x = x.to(torch.float64)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-300)


def rounding_codes(x: torch.Tensor, precision: int) -> torch.Tensor:
    """``round(x * 10**p)`` half away from zero, as int16."""
    y = x.to(torch.float64) * float(10 ** precision)
    return (torch.sign(y) * torch.floor(torch.abs(y) + 0.5)).to(torch.int16)


def trim_mask(x: torch.Tensor, threshold: float) -> torch.Tensor:
    return torch.abs(x.to(torch.float32)) >= threshold


def quantize32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Per-row int8 quantisation in float32 -> (codes, scale, zero)."""
    v = v.to(torch.float32)
    lo = torch.amin(v, dim=-1, keepdim=True)
    hi = torch.amax(v, dim=-1, keepdim=True)
    zero = (hi + lo) * 0.5
    scale = torch.clamp(hi - lo, min=1e-8) / torch.tensor(
        254.0, dtype=torch.float32, device=v.device)
    q = torch.clamp(torch.round((v - zero) / scale), -127, 127)
    return q.to(torch.int8), scale[:, 0], zero[:, 0]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float64)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away), as a TF32 product rounds its inputs."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + (1 << 12)) & ~((1 << 13) - 1)
    return b.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Layout:
    scorer: str            # "codes" or "int8"
    shards: int
    page: int
    k: int
    precision: int = 2     # rounding encoder's decimals (codes)
    trim: Optional[float] = None
    band_rel: float = 1e-4


class Reference:
    """The reference over one run's inputs: the base rows (N, n) and the
    appended bulks, as the benchmark made them (float32, any device)."""

    def __init__(self, layout: Layout, base: torch.Tensor,
                 bulks: Sequence[torch.Tensor] = ()):
        self.lay = layout
        self.dev = base.device
        self.N = base.shape[0]
        self.S = layout.shards
        self.dp = -(-self.N // self.S)
        for b in bulks:
            if b.shape[0] % self.S:
                raise ValueError("appended bulks must be a multiple of the "
                                 "shard count")
        if layout.scorer == "codes" and len(bulks):
            raise ValueError("the codes scorer is judged without ingest")
        self.bulk_sizes = [int(b.shape[0]) for b in bulks]
        self.bulk_start = np.concatenate(
            [[0], np.cumsum(self.bulk_sizes)]).astype(np.int64)
        self.base = normalize32(base)
        self.app = (normalize32(torch.cat(list(bulks))) if len(bulks)
                    else self.base[:0])
        self.n_app = self.app.shape[0]
        if layout.scorer == "codes":
            self._hist = self._code_histogram()
        elif layout.scorer != "int8":
            raise ValueError(f"unknown scorer {layout.scorer!r}")

    # ------------------------------------------------------------ phase 1
    def _code_histogram(self) -> torch.Tensor:
        """(C, 2M+1) document count of every (column, bucket) token."""
        M = 10 ** self.lay.precision
        C = self.base.shape[1]
        hist = torch.zeros(C * (2 * M + 1), dtype=torch.int64,
                           device=self.dev)
        col = torch.arange(C, device=self.dev) * (2 * M + 1) + M
        for r in range(0, self.N, _ROWS):
            c = rounding_codes(self.base[r:r + _ROWS], self.lay.precision)
            hist += torch.bincount((c.to(torch.int64) + col).reshape(-1),
                                   minlength=hist.numel())
        return hist.view(C, 2 * M + 1)

    def _weights(self, q32: torch.Tensor):
        """-> (query codes (Q, C), float64 weights (Q, C))."""
        M = 10 ** self.lay.precision
        qc = rounding_codes(q32, self.lay.precision)
        C = qc.shape[1]
        df = self._hist[torch.arange(C, device=self.dev)[None, :],
                        qc.to(torch.int64) + M].to(torch.float64)
        w = torch.log1p((self.N - df + 0.5) / (df + 0.5))
        if self.lay.trim is not None:
            w = torch.where(trim_mask(q32, self.lay.trim), w, 0.0)
        return qc, w

    def _phase1(self, rows: torch.Tensor, q32: torch.Tensor, aux) -> \
            torch.Tensor:
        """float64 phase-1 scores (Q, len(rows)) of unit float32 rows."""
        out = torch.empty((q32.shape[0], rows.shape[0]), dtype=torch.float64,
                          device=self.dev)
        if self.lay.scorer == "codes":
            qc, w = aux
            step = max(1, (1 << 25) // max(q32.shape[0] * rows.shape[1], 1))
            for r in range(0, rows.shape[0], step):
                c = rounding_codes(rows[r:r + step], self.lay.precision)
                eq = c[None, :, :] == qc[:, None, :]
                out[:, r:r + step] = torch.where(
                    eq, w[:, None, :], 0.0).sum(-1)
        else:
            q64 = aux
            qsum = q64.sum(-1, keepdim=True)
            for r in range(0, rows.shape[0], _ROWS):
                c, sc, zp = quantize32(rows[r:r + _ROWS])
                raw = q64 @ c.to(torch.float64).T
                out[:, r:r + _ROWS] = (raw * sc.double()[None, :]
                                       + qsum * zp.double()[None, :])
        return out

    # ---------------------------------------------------------- the judge
    def app_shard(self, j: np.ndarray) -> np.ndarray:
        """Shard of the appended row ``j`` (global id ``N + j``)."""
        return j % self.S

    def _scored(self, q: torch.Tensor, phase1_bf16: bool = False):
        """Phase 1 of a chunk of queries -> (q32, q64, aux, each shard's
        top page of the base (values, global ids) as numpy, every appended
        row's score (Qc, n_app)).  ``phase1_bf16`` rounds phase 1's query
        side to bfloat16: the idf weights (``codes``) or the query vector
        (``int8``)."""
        q32 = normalize32(q.to(self.dev))
        q64 = unit64(q.to(self.dev))
        aux = self._weights(q32) if self.lay.scorer == "codes" else q64
        if phase1_bf16:
            aux = ((aux[0], _bf16(aux[1])) if self.lay.scorer == "codes"
                   else _bf16(aux))
        base_top = []
        for s in range(self.S):
            rows = self.base[s * self.dp:(s + 1) * self.dp]
            p = self._phase1(rows, q32, aux)
            v, i = torch.topk(p, min(self.lay.page, p.shape[1]), dim=1)
            base_top.append((v.cpu().numpy(), i.cpu().numpy() + s * self.dp))
            del p
        p_app = (self._phase1(self.app, q32, aux).cpu().numpy()
                 if self.n_app else np.zeros((q32.shape[0], 0)))
        return q32, q64, aux, base_top, p_app

    def _shard_pool(self, i, s, base_top, p_app, n_bulks):
        """Query i's candidates on shard s with ``n_bulks`` bulks visible
        -> (values, global ids): the base's top page and the visible
        appended rows of the shard."""
        j = np.arange(self.n_app)
        own = (self.app_shard(j) == s) & (j < self.bulk_start[n_bulks])
        return (np.concatenate([base_top[s][0][i], p_app[i][own]]),
                np.concatenate([base_top[s][1][i], self.N + j[own]]))

    def _threshold(self, vals: np.ndarray) -> float:
        if vals.size < self.lay.page:
            return -np.inf
        return float(np.partition(vals, vals.size - self.lay.page)
                     [vals.size - self.lay.page])

    def judge(self, queries: torch.Tensor, ids: np.ndarray,
              scores: np.ndarray, n_req: Optional[np.ndarray] = None,
              n_pos: Optional[np.ndarray] = None) -> Dict[str, float]:
        """Compare the answers (``ids``, ``scores``: (Q, k)) to the
        queries (Q, n) float32 -> the three numbers, each the largest over
        the queries.  ``n_req`` / ``n_pos`` are the bulks acknowledged /
        begun when each query was sent."""
        Qn = queries.shape[0]
        n_req = np.zeros(Qn, np.int64) if n_req is None else np.asarray(n_req)
        n_pos = n_req if n_pos is None else np.asarray(n_pos)
        worst = dict.fromkeys(NUMBERS, 0.0)
        for a in range(0, Qn, _QCHUNK):
            q32, q64, aux, base_top, p_app = self._scored(
                queries[a:a + _QCHUNK])
            for i in range(q32.shape[0]):
                nums = self._judge_one(i, q32, q64, aux, base_top, p_app,
                                       ids[a + i], scores[a + i],
                                       int(n_req[a + i]), int(n_pos[a + i]))
                for key in NUMBERS:
                    worst[key] = max(worst[key], nums[key])
        return worst

    def _rows(self, gids: np.ndarray) -> torch.Tensor:
        g = torch.as_tensor(gids, dtype=torch.int64, device=self.dev)
        out = self.base[g.clamp(max=self.N - 1)]
        if self.n_app:
            a = self.app[(g - self.N).clamp(0, self.n_app - 1)]
            out = torch.where((g < self.N)[:, None], out, a)
        return out

    def _judge_one(self, i, q32, q64, aux, base_top, p_app, ids, scores,
                   n_req, n_pos):
        lay = self.lay
        t_a = np.empty(self.S)
        sure = []
        for s in range(self.S):
            va, ga = self._shard_pool(i, s, base_top, p_app, n_req)
            vb, _ = self._shard_pool(i, s, base_top, p_app, n_pos)
            t_a[s] = self._threshold(va)
            t_b = self._threshold(vb)
            cut = (t_b + lay.band_rel * abs(t_b) if np.isfinite(t_b)
                   else -np.inf)
            sure.append(ga[va > cut])
        sure_ids = np.concatenate(sure)
        cos_sure = (self._rows(sure_ids).double() @ q64[i]).cpu().numpy()
        ref = np.sort(cos_sure)[::-1][:lay.k]

        ids = np.asarray(ids, np.int64)
        scores = np.asarray(scores, np.float64)
        n_vis = self.N + int(self.bulk_start[n_pos])
        valid = (ids >= 0) & (ids < n_vis)
        first = np.unique(ids, return_index=True)[1]
        uniq = np.zeros(ids.shape, bool)
        uniq[first] = True
        valid &= uniq
        prog_cos = np.full(ids.shape, -1.0)
        score_err = 0.0
        shortfall = 0.0 if valid.all() else 1.0
        if valid.any():
            g = ids[valid]
            c = (self._rows(g).double() @ q64[i]).cpu().numpy()
            prog_cos[valid] = c
            err = np.abs(scores[valid] - c)
            score_err = float(np.max(np.where(np.isfinite(err), err, 2.0)))
            a = ((aux[0][i:i + 1], aux[1][i:i + 1]) if lay.scorer == "codes"
                 else aux[i:i + 1])
            p = self._phase1(self._rows(g), q32[i:i + 1], a)[0].cpu().numpy()
            sh = np.where(g < self.N, g // self.dp,
                          self.app_shard(np.maximum(g - self.N, 0)))
            thr = t_a[sh]
            fin = np.isfinite(thr)
            rel = np.zeros(g.shape)
            rel[fin] = (thr[fin] - p[fin]) / np.maximum(np.abs(thr[fin]),
                                                        1e-12)
            shortfall = max(shortfall, float(np.max(np.maximum(rel, 0.0))))
        prog = np.sort(prog_cos)[::-1]
        m = min(len(ref), len(prog))
        gaps = np.clip(ref[:m] - prog[:m], 0.0, 2.0)
        gap = float(gaps.max()) if m else 0.0
        return {"score_err": score_err, "rank_gap": gap,
                "page_shortfall": min(shortfall, 1.0)}

    # -------------------------------------------------------- the control
    def control_answers(self, queries: torch.Tensor,
                        n_req: Optional[np.ndarray] = None,
                        tf32: bool = True, phase1_bf16: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """The reference put in the program's place: each shard's top
        ``page`` by the float64 phase-1 scores (with ``phase1_bf16``, on a
        bfloat16 query side) over the docs visible with ``n_req`` bulks,
        then the rescore in TF32 (``tf32=True``, the control) or float32
        -> (ids (Q, k), scores (Q, k))."""
        Qn = queries.shape[0]
        n_req = np.zeros(Qn, np.int64) if n_req is None else np.asarray(n_req)
        out_i = np.zeros((Qn, self.lay.k), np.int64)
        out_s = np.zeros((Qn, self.lay.k), np.float32)
        for a in range(0, Qn, _QCHUNK):
            q32, _, _, base_top, p_app = self._scored(
                queries[a:a + _QCHUNK], phase1_bf16)
            for i in range(q32.shape[0]):
                cand = []
                for s in range(self.S):
                    v, g = self._shard_pool(i, s, base_top, p_app,
                                            int(n_req[a + i]))
                    top = np.argsort(-v, kind="stable")[:self.lay.page]
                    cand.append(g[top])
                cand = np.concatenate(cand)
                vec, qq = self._rows(cand), q32[i]
                if tf32:
                    vec, qq = tf32_round(vec), tf32_round(qq)
                s2 = (vec @ qq).cpu().numpy()
                top = np.argsort(-s2, kind="stable")[:self.lay.k]
                out_i[a + i] = cand[top]
                out_s[a + i] = s2[top]
        return out_i, out_s
