"""Host-staging accounting.

The port's own copy of ``rocnrdma_tpu/collectives/staging.py``.

BASELINE.md config 3's acceptance criterion is qualitative-but-hard:
a cross-slice allreduce "completes with **zero** host-DRAM staging".
Every byte the collective path bounces through host memory is counted
here, so the zero-staging property is a testable assertion rather than
a claim — and so the fallback (staged) path reports honestly how far
from the target it runs.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class StagingAccount:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bytes = 0
        self._ops = 0

    def add(self, nbytes: int) -> None:
        with self._lock:
            self._bytes += nbytes
            self._ops += 1

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def ops(self) -> int:
        with self._lock:
            return self._ops

    def reset(self) -> None:
        with self._lock:
            self._bytes = 0
            self._ops = 0

    @contextmanager
    def expect_zero(self):
        """Assert no host staging happens inside the block — the
        config-3 acceptance check."""
        before = self.bytes
        yield
        after = self.bytes
        if after != before:
            raise AssertionError(
                f"host staging occurred: {after - before} bytes "
                "(target is zero-copy)")


staging = StagingAccount()
