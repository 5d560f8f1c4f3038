"""moe_roofline.decode-hybrid: the grouped expert GEMMs' share of their
roofline over the held experts in the traced segment (%); see
``readers_kimi.moe_roofline``."""

from benchmark.readers_kimi import moe_roofline as read  # noqa: F401
