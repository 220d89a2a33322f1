"""Page selection: the page of a composed engine's dense (Q, d) scores."""

from .ops import page_select
from .ref import page_select_ref

__all__ = ["page_select", "page_select_ref"]
