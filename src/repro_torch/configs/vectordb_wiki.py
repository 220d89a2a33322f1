"""The paper's own system as a dry-runnable arch: English-Wikipedia-scale
semantic search (4,181,352 articles -- padded to 4,181,504 = 8167 x 512 --
x LSA-400, unit-normalised), rounding-P2 int8 codes, trim 0.05, page 320.

Cells (beyond the ten assigned archs'):
* ``search_b128`` -- throughput shape: 128 queries, two-phase search
* ``search_b1``   -- latency shape: 1 query
* ``encode_4m``   -- index build: fused normalize+quantize of the corpus

Docs shard over ("pod", "data") -- the analogue of the paper's 48 ES
shards; feature and code columns stay whole (400 is awkward / 16).

The JAX package's ``configs/vectordb_wiki.py``.  Phase 1's weights are 1
or 0, so its scores are whole counts and ties at the page's edge are the
rule: the page is a stable top-``page`` (``core.rerank.stable_topk``, ties
to the lower index as ``jax.lax.top_k``).  ``_encode`` goes through the
bucketize wrapper: on the card its hand-written kernel, elsewhere its
plain version, which is what the reference's ``_encode`` calls.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import Cell, P, _bspec, _sds
from repro_torch.core.codes import score_codes
from repro_torch.core.encoding import RoundingEncoder
from repro_torch.core.filtering import TrimFilter, expand_mask, feature_mask
from repro_torch.core.rerank import normalize, rerank_topk, stable_topk
from repro_torch.kernels.bucketize import ops as bucketize_ops

N_DOCS = 4_181_504          # 4,181,352 padded to x512
N_FEATURES = 400
ENCODER = RoundingEncoder(2)


def _page(doc_codes, queries, page: int, trim: float):
    """Phase 1 -> (unit queries, the (Q, page) candidate page)."""
    q = normalize(queries.to(torch.float32))
    qcodes = ENCODER.encode(q)
    mask = expand_mask(feature_mask(q, trim=TrimFilter(trim)),
                       qcodes.shape[-1])
    w = torch.where(mask, 1.0, 0.0)
    scores1 = score_codes(doc_codes, qcodes, w)
    _, cand = stable_topk(scores1, page)
    return q, cand


def _search(doc_vecs, doc_codes, queries, page: int, k: int, trim: float):
    q, cand = _page(doc_codes, queries, page, trim)
    return rerank_topk(doc_vecs, cand, q, k)


def _encode(vectors):
    return bucketize_ops.bucketize(vectors, "round", float(ENCODER.scale),
                                   ENCODER.code_dtype)


class VectorDBArch:
    family = "vectordb"
    SHAPES = {
        "search_b128": dict(kind="search", queries=128, page=320),
        "search_b1": dict(kind="search", queries=1, page=320),
        "encode_4m": dict(kind="encode"),
    }
    skip_shapes = ()

    def cell(self, shape_name: str, mesh) -> Cell:
        info = self.SHAPES[shape_name]
        vecs = _sds((N_DOCS, N_FEATURES), torch.float32)
        codes = _sds((N_DOCS, N_FEATURES), ENCODER.code_dtype)
        if info["kind"] == "encode":
            return Cell(
                arch="vectordb-wiki", shape=shape_name, kind="encode",
                fn=_encode, args=(vecs,),
                in_specs=(_bspec(mesh, vecs),),
                out_specs=_bspec(mesh, codes),
            )
        fn = functools.partial(_search, page=info["page"], k=10, trim=0.05)
        qs = _sds((info["queries"], N_FEATURES), torch.float32)
        return Cell(
            arch="vectordb-wiki", shape=shape_name, kind="search",
            fn=fn, args=(vecs, codes, qs),
            in_specs=(_bspec(mesh, vecs), _bspec(mesh, codes), P()),
            out_specs=(P(), P()),
            note="paper system: trim=0.05, page=320, P2 int8 codes",
        )


ARCH = VectorDBArch()
