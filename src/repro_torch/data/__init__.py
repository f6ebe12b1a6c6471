"""Data pipelines of the port: the LM token stream and the prefetch
helpers."""
from .synthetic import (MultiStreamPrefetcher, PrefetchIterator,
                        SyntheticTokenStream, TokenStreamConfig)

__all__ = ["PrefetchIterator", "MultiStreamPrefetcher",
           "SyntheticTokenStream", "TokenStreamConfig"]
