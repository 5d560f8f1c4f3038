"""mfu.decode: the whole window's share of the chip's peak (%); see
``readers.mfu_generate``."""

from benchmark.readers import mfu_generate as read  # noqa: F401
