"""Request serving: the batched search engine."""

from .engine import BatchedSearchEngine

__all__ = ["BatchedSearchEngine"]
