"""kernels_roofline.decode: the port's kernels' share of their roofline in
the traced segment (%); see ``readers.kernels_roofline``."""

from benchmark.readers import kernels_roofline as read  # noqa: F401
