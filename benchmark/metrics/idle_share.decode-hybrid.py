"""idle_share.decode-hybrid: the device's idle share of the traced segment
(%); see ``readers.idle_share``."""

from benchmark.readers import idle_share as read  # noqa: F401
