"""kda_roofline.decode-hybrid: K9's share of its roofline in the traced
segment (%); see ``readers_kimi.kda_roofline``."""

from benchmark.readers_kimi import kda_roofline as read  # noqa: F401
