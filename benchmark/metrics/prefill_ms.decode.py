"""prefill_ms.decode: device ms of a call's prefill (the program's
``generate.prefill`` span); see ``spans.prefill_ms``."""

from benchmark.spans import prefill_ms as read  # noqa: F401
