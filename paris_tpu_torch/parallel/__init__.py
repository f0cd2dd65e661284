"""The distributed path: one process per card, z-blocks sharded over the
ranks of a ``torch.distributed`` group (port of ``paris_tpu/parallel``)."""

from .dist import DistributedReconstructor, owned_slots
from .multihost import initialize, is_multihost

__all__ = ["DistributedReconstructor", "owned_slots", "initialize",
           "is_multihost"]
