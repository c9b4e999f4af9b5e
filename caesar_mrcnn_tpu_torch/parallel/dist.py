"""Communication between processes: host-side (Python object) data, the
process group and its backend.

The port of ``caesar_mrcnn_tpu/parallel/dist.py`` over ``torch.distributed``:

* :class:`SerialComm`, the no-op communicator of a run of one process;
* :class:`TorchDistComm`, the counterpart of the JAX package's
  ``JaxDistComm``: the same interface (``rank``, ``size``, ``barrier``,
  ``gather`` to rank 0, ``allgather``) and the same exchange, zlib-compressed
  pickles sent as uint8 tensors, first their lengths, then ``CHUNK``-byte
  rounds, so that peak memory stays at ``size * chunk`` however long one
  rank's payload is (``all_gather_object`` would pad every rank to the
  longest payload at once);
* :func:`init_process_group` and :func:`init_from_env` (torchrun's
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), with a timeout, so that a rank that never arrives
  fails the run instead of hanging it; the backend follows from the device
  assignment (:func:`choose_backend`);
* :func:`get_comm`.

* :func:`all_reduce_tensors_` and :func:`broadcast_tensors_`, one
  collective per flat bucket, on the tensors' own device under either
  backend (Gloo takes CUDA tensors too); the gradient all-reduce and the
  global loss sums that use them live in ``train/trainer.py`` and
  ``models/losses.py``;
* :func:`all_reduce_sum`, a sum over the ranks under autograd (the global
  batch statistics of ``models/layers.py::BatchNorm``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import zlib
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for a rank that does not arrive
TIMEOUT_S = 600.0


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


def exchange_device(group=None) -> torch.device:
    """Where a collective's tensors live: the rank's card under NCCL (it
    takes CUDA tensors only), the CPU under Gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class TorchDistComm:
    """Communicator over an initialized ``torch.distributed`` group."""

    # Per-round chunk of the payload exchange: bounds peak memory at
    # size * chunk instead of size * longest payload.
    CHUNK = 4 << 20

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = exchange_device(group)

    def barrier(self) -> None:
        # an all-reduce on the exchange device, not dist.barrier, which
        # under NCCL guesses the rank's card from its global rank
        flag = torch.zeros(1, device=self.device)
        dist.all_reduce(flag, group=self.group)

    def _allgather_tensor(self, t: torch.Tensor) -> List[torch.Tensor]:
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def allgather(self, obj: Any, chunk: Optional[int] = None) -> List[Any]:
        """Allgather arbitrary Python objects, in ``chunk``-byte rounds.
        Ranks whose payload is exhausted send zeros for the remaining
        rounds; the rounds stop at the longest payload."""
        chunk = chunk or self.CHUNK
        payload = np.frombuffer(zlib.compress(pickle.dumps(obj), 1), dtype=np.uint8)
        # 1) agree on lengths
        mine = torch.tensor([payload.size], dtype=torch.int64, device=self.device)
        lengths = [int(t.item()) for t in self._allgather_tensor(mine)]
        max_len = max(lengths)
        # 2) exchange payloads in chunk-size rounds
        parts: List[List[np.ndarray]] = [[] for _ in range(self.size)]
        for off in range(0, max(max_len, 1), chunk):
            round_len = min(chunk, max_len - off) if max_len else 1
            seg = np.zeros(round_len, dtype=np.uint8)
            have = payload[off: off + round_len]
            seg[: have.size] = have
            got = self._allgather_tensor(torch.from_numpy(seg).to(self.device))
            for i in range(self.size):
                parts[i].append(got[i].cpu().numpy())
        out = []
        for i in range(self.size):
            blob = np.concatenate(parts[i])[: lengths[i]].tobytes()
            out.append(pickle.loads(zlib.decompress(blob)))
        return out

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Gather to rank 0; returns list on master, None elsewhere."""
        out = self.allgather(obj)
        return out if self.rank == 0 else None


def choose_backend(device, local_world_size: int) -> str:
    """NCCL when every rank of this host has a card of its own; Gloo on
    the CPU, or when ranks share a card (NCCL refuses two ranks on one
    device)."""
    device = torch.device(device)
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world_size: int, device, address: str = "localhost", port: int = 29500,
                       local_world_size: Optional[int] = None, timeout_s: float = TIMEOUT_S) -> str:
    """Join a group of ``world_size`` processes at ``address:port`` as
    ``rank``; sets the rank's card as the current one. Returns the
    backend (:func:`choose_backend`; ``local_world_size`` defaults to the
    whole group, one host)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(device, world_size if local_world_size is None else local_world_size)
    dist.init_process_group(backend, init_method=f"tcp://{address}:{port}", rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def free_port() -> int:
    """A free TCP port on localhost, for a group of this host's processes."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launcher_env() -> Optional[dict]:
    """torchrun's variables as ints and strings, or None outside a
    launcher (no ``WORLD_SIZE``)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return {
        "rank": int(os.environ.get("RANK", "0")),
        "world_size": world,
        "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
        "local_world_size": int(os.environ.get("LOCAL_WORLD_SIZE", str(world))),
        "address": os.environ.get("MASTER_ADDR", "localhost"),
        "port": int(os.environ.get("MASTER_PORT", "29500")),
    }


def rank_device(kind: str, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:(local_rank % cards)``, so that ranks share
    the cards there are, or the CPU."""
    if torch.device(kind).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the rank (ask for the CPU to run there)")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_from_env(device="cuda", timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the launcher's group (torchrun's variables) on the rank's
    device of ``device``'s kind (:func:`rank_device`), and return that
    device. A launcher of one process initializes nothing."""
    env = launcher_env()
    if env is None:
        raise RuntimeError("init_from_env: no launcher variables (WORLD_SIZE, RANK, ...) are set")
    dev = rank_device(device, env["local_rank"])
    if env["world_size"] > 1 and not dist.is_initialized():
        init_process_group(env["rank"], env["world_size"], dev, env["address"], env["port"],
                           env["local_world_size"], timeout_s)
    return dev


def world_size() -> int:
    """Processes in this run: ``torch.distributed``'s group when one is
    initialized, else the launcher's ``WORLD_SIZE`` (torchrun sets it), else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def get_comm():
    """The communicator of this process: :class:`TorchDistComm` over the
    initialized group of more than one process, :class:`SerialComm` for
    one. A launcher's ``WORLD_SIZE`` above 1 without an initialized group
    raises, so that no rank writes a catalog of its own tiles alone."""
    if dist.is_available() and dist.is_initialized():
        return TorchDistComm() if dist.get_world_size() > 1 else SerialComm()
    n = world_size()
    if n > 1:
        raise RuntimeError(
            f"WORLD_SIZE={n} but no torch.distributed group is initialized: call "
            "parallel.dist.init_from_env(device) first"
        )
    return SerialComm()


# Flat buckets of the gradient all-reduce and the parameter broadcast: one
# collective per bucket of consecutive tensors of one dtype, not one per
# tensor.
BUCKET_BYTES = 64 << 20


def flat_buckets(tensors: List[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> List[List[int]]:
    """Indices of ``tensors`` in consecutive runs of one dtype and device,
    each of at most ``bucket_bytes`` (or one tensor, if it is larger)."""
    buckets: List[List[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        k = (t.dtype, t.device)
        if not buckets or k != key or size + nbytes > bucket_bytes:
            buckets.append([])
            size, key = 0, k
        buckets[-1].append(i)
        size += nbytes
    return buckets


def _bucketed_(tensors: List[torch.Tensor], collective, bucket_bytes: int) -> None:
    for idx in flat_buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))


def all_reduce_tensors_(tensors: List[torch.Tensor], group=None, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each tensor over the ranks in place, in flat buckets."""
    _bucketed_(tensors, lambda flat: dist.all_reduce(flat, group=group), bucket_bytes)


def broadcast_tensors_(tensors: List[torch.Tensor], src: int = 0, group=None,
                       bucket_bytes: int = BUCKET_BYTES) -> None:
    """Overwrite each tensor with rank ``src``'s, in flat buckets."""
    _bucketed_(tensors, lambda flat: dist.broadcast(flat, src, group=group), bucket_bytes)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the sum of the incoming
    gradients over the ranks (``torch.nn.SyncBatchNorm``'s rule): every
    rank's output is the same global sum, so each rank's input reaches the
    loss terms of every rank through it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, with the gradient of the
    global sum (:class:`_AllReduceSum`). Every rank must call it, in the same
    order, in the forward and, when a gradient reaches it, in the backward."""
    return _AllReduceSum.apply(x, group)
