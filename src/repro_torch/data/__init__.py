"""Data pipelines of the port: the streaming ingest helpers."""
from .synthetic import MultiStreamPrefetcher, PrefetchIterator

__all__ = ["PrefetchIterator", "MultiStreamPrefetcher"]
