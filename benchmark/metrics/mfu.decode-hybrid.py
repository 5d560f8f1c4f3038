"""mfu.decode-hybrid: the whole window's share of the chip's peak (%); see
``readers_kimi.mfu_generate``."""

from benchmark.readers_kimi import mfu_generate as read  # noqa: F401
