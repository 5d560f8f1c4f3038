"""One static-shape step, captured once as a CUDA graph and replayed.

The port's counterpart of the JAX package's ``jax.jit`` around a decode
step: where JAX traces a step once and runs the compiled executable,
the port records the step's kernels once into a CUDA graph and replays
it, so the host issues one replay where it issued every kernel.

A step is a function of no arguments that reads and writes only static
tensors, allocated before the capture and updated in place: the graph
bakes their addresses in. Its first call on a card:

1. warms the step on a side stream (what ``torch.cuda.graph`` asks, so
   the lazy ``nvcc`` build, the kernels' one-time attributes and cuBLAS's
   workspaces come before the capture) — the warm-up IS that call's step,
   so its writes are the ones a replay would have made;
2. captures the step (which launches nothing).

Every later call replays the graph. A capture or replay error raises;
nothing falls back to running the step eagerly. On the CPU the step runs
uncaptured on every call: the caller asked for the CPU, and this is the
same step the CPU tests hold against the JAX package.

Launch counts stay exact through replays: what the capturing thread's
wrappers count while the step is recorded goes into a tally of its own
(``_native.tally_launches``), since the capture launches nothing, and
each replay adds that tally (``_native.count(name, n)``). Launches that
other threads make meanwhile count as they happen, outside the tally.

Each capture (the warm-up step and the recording) is a ``graph.capture``
span of the tracer, so a graph captured again inside a traced unit shows
by name.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from ..ops import _native
from .trace import trace

__all__ = ["CapturedStep", "captures"]

_captures = 0


def captures() -> int:
    """Graphs captured in this process so far."""
    return _captures


class CapturedStep:
    """``fn`` on ``device``, captured at its first call and replayed after.

    ``pool``: a graph memory pool (``torch.cuda.graph_pool_handle()``)
    shared with other steps that never run concurrently with this one;
    safe when ``fn`` writes its results into static tensors, so every
    allocation made inside the capture is freed by its end.
    ``generators``: the ``torch.Generator``s ``fn`` draws from besides the
    device's default one, registered with the graph so each replay draws
    from their current state and advances it.

    The capture runs in ``"thread_local"`` error mode: CUDA calls that
    other threads of the process make meanwhile (a serving rank's stream
    threads, another rank's thread in a world of threads) do not abort
    it, while an unsafe call in the capturing thread still does.
    """

    def __init__(self, fn: Callable[[], None], device: torch.device, *,
                 pool=None,
                 generators: Iterable[torch.Generator] = ()) -> None:
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.generators = tuple(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # Kernel launches of one replay, by kernel name.
        self.launches: Dict[str, int] = {}

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif self.graph is None:
            with trace.span("graph.capture", self.device):
                self._warm_and_capture()
        else:
            self.graph.replay()
            for name, n in self.launches.items():
                _native.count(name, n)

    def _warm_and_capture(self) -> None:
        global _captures
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                graph.register_generator_state(gen)
            with _native.tally_launches() as counted, \
                    torch.cuda.graph(graph, pool=self.pool,
                                     capture_error_mode="thread_local"):
                self.fn()
        self.graph, self.launches = graph, counted
        _captures += 1
