"""Training metrics stream (port of ``MetricsLogger`` in
``caesar_mrcnn_tpu/train/observability.py``): the same file
(``<name>_metrics.jsonl``), rows and keys. The loss-curve PNG needs
matplotlib, which the port does not use (ROADMAP A16c). The JAX module's
``PhaseTimer`` and ``device_trace`` have their counterpart in the port's
``telemetry.py`` (spans and counters, under ``torch.profiler``
``user_annotation`` events when a profiler runs), which spans the detect
path and not yet the train step; the FLOP and roofline counts are the
benchmark's (``benchmark/flops.py``, ``benchmark/bounds.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream + in-memory history."""

    def __init__(self, logdir: str, name: str = "train"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{name}_metrics.jsonl")
        self.history: List[Dict] = []

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self.history.append(row)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def plot_losses(self, outfile: str, keys: Optional[List[str]] = None) -> None:
        raise NotImplementedError(
            "MetricsLogger.plot_losses: the loss curve needs matplotlib, which the port does not use; "
            "drawing waits for ROADMAP item A16c"
        )
