"""Serving data path of the port: streaming transfer engine,
weight/KV-page prefetch, and continuous batching on the card.

Only the loopback path (``world=None``) runs in the port so far; the
wire path waits for the transport port. The heavy submodules
(:mod:`.pager`, :mod:`.model`, :mod:`.batcher`) load lazily on first
attribute access.
"""

from __future__ import annotations

from .stream import (  # noqa: F401
    CreditGate, Inflight, TransferEngine, stream_depth,
    STREAM_BIT, make_stream_coll, is_stream_coll,
    stream_coll_request, stream_coll_seq,
)

__all__ = [
    "CreditGate", "Inflight", "TransferEngine", "stream_depth",
    "STREAM_BIT", "make_stream_coll", "is_stream_coll",
    "stream_coll_request", "stream_coll_seq",
    "stream", "pager", "model", "batcher",
]

_LAZY = ("pager", "model", "batcher", "stream")


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
