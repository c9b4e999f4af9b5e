"""Convert a weights checkpoint of the JAX package (an orbax directory
``mask_rcnn_<name>_NNNN``) into the PyTorch port's ``.pt`` weights.

Run where ``jax`` and ``orbax-checkpoint`` are installed (the port itself
imports neither):

    python3 tools/orbax_to_pt.py CHECKPOINT_DIR [--out DIR]

It restores the directory as the JAX package's ``load_checkpoint`` does
(``caesar_mrcnn_tpu/train/checkpoints.py``: orbax's ``StandardCheckpointer``),
keeps ``params`` and, where present, ``batch_stats``, maps that tree onto the
port's ``state_dict`` names and layouts with
``caesar_mrcnn_tpu_torch.weights.flax_to_state_dict``, and writes
``DIR/mask_rcnn_<name>_NNNN.pt`` (by default beside the directory), named
after the directory, which the port's ``restore_weights`` and ``find_last``
read. It converts weights only: a train-state directory (``..._state``:
weights, optimizer state and step) is refused, and so is a directory not
named as the JAX package names its weights.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

REPO = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^mask_rcnn_(?P<name>[\w\-.]+?)_(?P<epoch>\d{4})$")


def checkpoint_id(path: str) -> Tuple[str, int]:
    """(model name, epoch) of a weights directory ``mask_rcnn_<name>_NNNN``."""
    m = NAME.match(os.path.basename(os.path.normpath(path)))
    if m is None:
        raise SystemExit(f"{path}: not a weights checkpoint of the JAX package (mask_rcnn_<name>_NNNN)")
    return m.group("name"), int(m.group("epoch"))


def restore_flax(path: str) -> Dict:
    """``params`` (and ``batch_stats``) of an orbax weights directory, as
    numpy arrays."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    if "params" not in tree:
        raise SystemExit(f"{path}: no 'params' in the checkpoint (keys {sorted(tree)})")
    out = {"params": tree["params"]}
    if tree.get("batch_stats"):
        out["batch_stats"] = tree["batch_stats"]
    return jax.tree_util.tree_map(np.asarray, out)


def convert(path: str, out_dir: Optional[str] = None) -> str:
    """Write the ``.pt`` of the weights directory ``path``; returns its path."""
    path = os.path.normpath(path)
    if path.endswith("_state"):
        raise SystemExit(f"{path} is a train state (weights, optimizer state and step): this tool converts "
                         "weights checkpoints only (mask_rcnn_<name>_NNNN)")
    if not os.path.isdir(path):
        raise SystemExit(f"{path}: not an orbax checkpoint directory")
    name, epoch = checkpoint_id(path)
    sys.path.insert(0, str(REPO))
    import torch

    from caesar_mrcnn_tpu_torch.train.checkpoints import checkpoint_name
    from caesar_mrcnn_tpu_torch.weights import flax_to_state_dict

    state = flax_to_state_dict(restore_flax(path))
    out_dir = out_dir or os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, checkpoint_name(name, epoch) + ".pt")
    torch.save(state, out)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="orbax weights directory of the JAX package (mask_rcnn_<name>_NNNN)")
    p.add_argument("--out", default=None, help="directory of the .pt (default: beside the checkpoint)")
    args = p.parse_args(argv)
    print(convert(args.checkpoint, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
