"""mfu.train-long: the whole window's share of the chip's peak (%); see
``readers.mfu_train``."""

from benchmark.readers import mfu_train as read  # noqa: F401
