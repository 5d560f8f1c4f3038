"""mfu.decode-mla: the whole window's share of the chip's peak (%); see
``readers_mla.mfu_generate``."""

from benchmark.readers_mla import mfu_generate as read  # noqa: F401
