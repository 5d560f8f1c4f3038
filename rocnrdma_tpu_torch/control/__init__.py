"""Control plane: named rendezvous with leases and arbitrated rejoin
(the port's own copy of ``rocnrdma_tpu/control/``).

``coordinator`` is the single-process rendezvous/coordination service
(runnable via ``python -m rocnrdma_tpu_torch.tools.rendezvous``);
``client`` is the member side RingWorld embeds. The legacy pairwise bootstrap keeps working
with no coordinator — this package is the arbitrated upgrade path.
"""

from rocnrdma_tpu_torch.control.client import ControlClient, ControlError
from rocnrdma_tpu_torch.control.coordinator import Coordinator

__all__ = ["Coordinator", "ControlClient", "ControlError"]
