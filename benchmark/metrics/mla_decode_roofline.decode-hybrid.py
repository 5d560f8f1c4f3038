"""mla_decode_roofline.decode-hybrid: K7's share of its roofline (32 heads)
in the traced segment (%); see ``readers_kimi.mla_decode_roofline``."""

from benchmark.readers_kimi import mla_decode_roofline as read  # noqa: F401
