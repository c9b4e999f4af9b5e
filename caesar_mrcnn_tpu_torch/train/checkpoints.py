"""Checkpoint save and restore with partial loading by name (port of
``caesar_mrcnn_tpu/train/checkpoints.py`` with ``torch.save`` files in
place of orbax directories; the port reads no orbax directory itself:
``tools/orbax_to_pt.py``, run where orbax is installed, converts the JAX
package's weights checkpoints into these ``.pt`` files).

* :func:`restore_weights` is the entry point behind every ``--weights``
  flag: a ``.pt`` file of this module, or a reference-format Keras ``.h5``
  (``train/keras_import.py``);
* epoch-stamped files ``mask_rcnn_<name>_NNNN.pt`` (weights: parameters
  and batch-norm statistics) and ``..._NNNN_state.pt`` (weights, optimizer
  state and step, for an exact resume) under a run directory;
* :func:`find_last` finds the newest weights file;
* :func:`partial_restore` loads stored tensors into a model by name,
  skipping names whose flax path matches an ``exclude`` regex and tensors
  whose shapes differ (retraining with another class or channel count).
  The patterns are the JAX package's, searched in the same flax paths
  (``params/backbone/conv1/kernel``, ``batch_stats/...``).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..weights import flax_path

log = logging.getLogger(__name__)


def checkpoint_name(model_name: str, epoch: int) -> str:
    return f"mask_rcnn_{model_name.lower()}_{epoch:04d}"


def save_checkpoint(ckpt_dir: str, model_name: str, epoch: int, model: torch.nn.Module) -> str:
    """Save the model's parameters and buffers for one epoch."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, checkpoint_name(model_name, epoch) + ".pt"))
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_state(ckpt_dir: str, model_name: str, epoch: int, model: torch.nn.Module,
                     optimizer, step: int) -> str:
    """Save weights, optimizer state and step for an exact resume."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, checkpoint_name(model_name, epoch) + "_state.pt"))
    opt = optimizer.state_dict()
    opt["state"] = {k: {n: t.detach().cpu() for n, t in v.items()} for k, v in opt["state"].items()}
    payload = {
        "step": int(step),
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": opt,
    }
    torch.save(payload, path)
    return path


def load_train_state(path: str, model: torch.nn.Module, optimizer) -> int:
    """Restore a :func:`save_train_state` file into ``model`` and
    ``optimizer`` (built with the same config); returns the step."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"])


def restore_weights(
    model: torch.nn.Module, path: str, exclude: Optional[Sequence[str]] = None
) -> Tuple[List[str], List[str]]:
    """Restore weights into ``model`` by name, in place, from a ``.pt``
    checkpoint of :func:`save_checkpoint` or a reference-format Keras
    ``.h5``/``.hdf5`` file; ``exclude`` as in :func:`partial_restore`.
    Returns (loaded names, skipped names)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package): the port reads .pt and .h5 "
            f"weights only. Convert it where jax and orbax are installed: python3 tools/orbax_to_pt.py {path}"
        )
    if path.endswith((".h5", ".hdf5")):
        from .keras_import import restore_from_keras_h5

        return restore_from_keras_h5(model, path, exclude=exclude)
    return partial_restore(model, load_checkpoint(path), exclude=exclude)


def find_last(ckpt_dir: str) -> Optional[str]:
    """Newest weights checkpoint of a run directory."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(
        n for n in os.listdir(ckpt_dir)
        if n.startswith("mask_rcnn_") and n.endswith(".pt") and not n.endswith("_state.pt")
    )
    return os.path.join(ckpt_dir, names[-1]) if names else None


def epoch_from_path(path: str) -> int:
    """The epoch counter in a checkpoint path (0 if none)."""
    m = re.search(r"mask_rcnn_[\w\-.]+?_(\d{4})(_state)?(\.pt)?$", os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else 0


def partial_restore(
    model: torch.nn.Module,
    stored: Dict[str, torch.Tensor],
    exclude: Optional[Sequence[str]] = None,
) -> Tuple[List[str], List[str]]:
    """Copy stored tensors into ``model`` by name, in place. Skips names
    whose flax path (``collection/path``, as ``weights.flax_path`` gives
    it) matches any ``exclude`` regex, names not stored, and
    tensors whose shapes differ. Returns (loaded names, skipped names)."""
    pats = [re.compile(p) for p in (exclude or [])]
    loaded: List[str] = []
    skipped: List[str] = []
    with torch.no_grad():
        for name, t in model.state_dict().items():
            value = stored.get(name)
            if (any(p.search("/".join(flax_path(name))) for p in pats) or value is None
                    or tuple(value.shape) != tuple(t.shape)):
                skipped.append(name)
                continue
            t.copy_(value)
            loaded.append(name)
    log.info("partial_restore: loaded %d tensors, skipped %d", len(loaded), len(skipped))
    return loaded, skipped
