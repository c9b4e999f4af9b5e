"""Communication of host-side (Python object) data between processes.

The port's copy of ``caesar_mrcnn_tpu/parallel/dist.py`` for one process:
:class:`SerialComm`, the no-op communicator that ``SFinder`` uses, and
:func:`get_comm`. The multi-process communicator (the JAX package's
``JaxDistComm``, over ``jax.distributed``) becomes a ``torch.distributed``
one with ROADMAP item A13; until then a run of more than one process
raises instead of having each process write a catalog of its own tiles.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional


class SerialComm:
    """Single-process no-op communicator."""

    rank = 0
    size = 1

    def barrier(self) -> None:
        pass

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Gather to rank 0; returns list on master, None elsewhere."""
        return [obj]

    def allgather(self, obj: Any) -> List[Any]:
        return [obj]


def world_size() -> int:
    """Processes in this run: ``torch.distributed``'s group when one is
    initialized, else the launcher's ``WORLD_SIZE`` (torchrun sets it), else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def get_comm() -> SerialComm:
    """The communicator of this process: :class:`SerialComm` in a run of
    one process. More than one raises: the port's multi-process
    communicator is ROADMAP item A13."""
    n = world_size()
    if n > 1:
        raise NotImplementedError(
            f"{n} processes: the port's multi-process communicator is ROADMAP item A13; "
            "run one process (SerialComm)"
        )
    return SerialComm()
