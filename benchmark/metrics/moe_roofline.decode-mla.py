"""moe_roofline.decode-mla: the grouped expert GEMMs' share of their
roofline in the traced segment (%); see ``readers_mla.moe_roofline``."""

from benchmark.readers_mla import moe_roofline as read  # noqa: F401
