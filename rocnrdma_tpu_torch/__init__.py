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
  package's flax parameter tree; ``models.convert``: the import of a
  HuggingFace Llama checkpoint;
- ``serving``: the paged decoder and the continuous batcher over
  streamed weight pages, alone or across ranks of a ``RingWorld``;
- ``parallel.trainer``: the train step, on one device or on an
  intra-slice dp × tp mesh (``parallel.mesh``, ``ops.sharding``,
  ``models.llama_mesh``), alone or across data-parallel slices;
- ``transport`` (ctypes bindings to ``libtdr``, built from this
  package's own copy of the native sources under ``native/``),
  ``collectives`` (``RingWorld`` and the cross-slice allreduce shim) and
  ``hbm`` (the pin registry and the ``CUDAExporter``): the RDMA data
  path the data-parallel trainer averages its gradients over.

Entry points run on the card unless the caller asks for the CPU: they
take ``device="cuda"`` by default and raise on a host without a GPU.

Importing the package itself does not import torch: each module that
needs torch imports it. So the control plane (``control``, the
coordinator process ``python -m rocnrdma_tpu_torch.tools.rendezvous``)
starts, and collects garbage, as the JAX package's does, without
torch's object graph.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Union

__version__ = "0.1.0"

from rocnrdma_tpu_torch.utils.trace import trace  # noqa: E402,F401

if TYPE_CHECKING:
    import torch

    DeviceLike = Union[str, torch.device, None]


def resolve_device(device: "DeviceLike" = "cuda") -> "torch.device":
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for and there is no GPU —
    the port never drops to the CPU on its own."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rocnrdma_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def __getattr__(name: str) -> Any:
    # ``DeviceLike`` names ``torch.device``, so it is built at its first
    # use (``from rocnrdma_tpu_torch import DeviceLike``), not at import.
    if name == "DeviceLike":
        import torch

        value = Union[str, torch.device, None]
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["resolve_device", "trace", "DeviceLike"]
