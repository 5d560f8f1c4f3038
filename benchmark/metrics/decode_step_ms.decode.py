"""decode_step_ms.decode: device ms of one graphed decode step (the
program's ``generate.decode`` span over its steps); see
``spans.decode_step_ms``."""

from benchmark.spans import decode_step_ms as read  # noqa: F401
