"""Plain PyTorch version of the page selection: ``stable_topk`` itself, a
stable descending sort of every row cut to the page (ties to the lower
position, as ``jax.lax.top_k`` breaks them)."""

from __future__ import annotations

from repro_torch.core.rerank import stable_topk as page_select_ref

__all__ = ["page_select_ref"]
