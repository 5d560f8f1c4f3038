"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .attention import (  # noqa: F401
    attention, attention_reference, flash_attention_lse,
    flash_attention_lse_reference)
from .rmsnorm import rmsnorm, rmsnorm_reference  # noqa: F401
