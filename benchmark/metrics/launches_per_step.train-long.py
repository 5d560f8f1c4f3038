"""launches_per_step.train-long: device kernels per training step in the
traced segment; see ``readers.launches_per_unit``."""

from benchmark.readers import launches_per_unit as read  # noqa: F401
