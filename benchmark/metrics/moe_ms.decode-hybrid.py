"""moe_ms.decode-hybrid: device ms of the held-expert layers in a call's
prefill (the program's ``moe.experts`` spans); see
``readers_mla.moe_ms``."""

from benchmark.readers_mla import moe_ms as read  # noqa: F401
