"""rocnrdma_tpu_torch — the PyTorch/CUDA port of ``rocnrdma_tpu``.

The JAX package beside this one is the reference; this package is its
counterpart for an NVIDIA H100. It imports ``torch`` and numpy and
nothing of JAX or of ``rocnrdma_tpu``: what it needs from the JAX
package's jax-free modules it keeps as its own copy.

Layout mirrors the JAX package so each counterpart is easy to find:

- ``ops``: the hand-written Hopper kernels (CUDA C++ under ``csrc/``,
  built with ``nvcc`` at first use and bound with ``ctypes``) and,
  beside each, its plain PyTorch version;
- ``models.llama``: the Llama family for inference (prefill,
  KV-cache decode, ``generate``) and the bridge from the JAX
  package's flax parameter tree;
- ``serving``: the paged decoder and the continuous batcher over
  streamed weight pages.

Entry points run on the card unless the caller asks for the CPU: they
take ``device="cuda"`` by default and raise on a host without a GPU.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

from rocnrdma_tpu_torch.utils.trace import trace  # noqa: E402,F401

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for and there is no GPU —
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rocnrdma_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


__all__ = ["resolve_device", "trace", "DeviceLike"]
