"""mla_decode_roofline.decode-mla: K7's share of its roofline in the
traced segment (%); see ``readers_mla.mla_decode_roofline``."""

from benchmark.readers_mla import mla_decode_roofline as read  # noqa: F401
