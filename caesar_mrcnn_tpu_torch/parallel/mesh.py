"""The devices of data parallelism and each one's rows of a global batch
(the port's counterpart of ``caesar_mrcnn_tpu/parallel/mesh.py``).

The JAX package shards the batch over a 1-D ``data`` mesh inside one
jitted program. The port runs one model replica per device: in one
process (``inference.detector.Detector`` over :func:`local_devices`) or one
process per device (``train.trainer`` over a ``torch.distributed`` group).
Either way the global batch (``images_per_device * num_devices``, the
config's ``batch_size``) is cut into contiguous, equal slices in device
order, as ``shard_batch`` splits it over the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch


def local_devices(kind: str = "cuda", n: int = 1) -> List[torch.device]:
    """The first ``n`` devices of ``kind``: cards ``cuda:0 .. cuda:n-1``,
    fewer when fewer exist (none without a card); on the CPU ``n`` entries
    of ``cpu``, which stand in for cards."""
    if torch.device(kind).type == "cuda":
        return [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
    return [torch.device("cpu")] * n


def shard_rows(global_batch: int, n: int, index: int) -> slice:
    """The contiguous rows of slice ``index`` of ``n`` equal slices of a
    global batch, which ``n`` must divide."""
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} devices")
    per = global_batch // n
    return slice(index * per, (index + 1) * per)


def shard_batch(batch: Dict[str, Any], n: int, index: int) -> Dict[str, Any]:
    """Slice ``index``'s rows of every array of a global batch dict."""
    rows = shard_rows(len(next(iter(batch.values()))), n, index)
    return {k: v[rows] for k, v in batch.items()}
