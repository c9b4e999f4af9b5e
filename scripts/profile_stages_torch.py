"""Per-stage profile of the PyTorch port's train step on one CUDA card.

Run from the repository root on the machine with the card:

    python3 scripts/profile_stages_torch.py [--reps 20] [--out build/profile_stages.json]

Train step, at the training flagship (ResNet-101, 256^2, batch 8, bf16,
Adam, 6000 / 2000 proposals, 512 ROIs, 300 GT; 16 seeded FITS images of 12
sources through ``TrainingPipeline``, the compact wire): the host batch
(``next`` of ``TrainingPipeline.batches``, host clock), ``batch_to_device``,
``mold_batch``, the forward with the losses, the backward, the optimizer.

Each device stage is timed by CUDA events around it (median of ``--reps``
runs after two warm-up runs), and its device kernels are summed by
``torch.profiler`` (a second pass of the same stage), with the largest
three by name. ``--device cpu`` rehearses the script's control flow on
the CPU with host clocks; its numbers are not device measurements.

The detect step's stages are the port's telemetry spans
(``caesar_mrcnn_tpu_torch/telemetry.py``: ``detect.stage_in``,
``detect.step.features``, ``.proposals``, ``.heads``, ``detect.unmold``),
read on the pipelined path by ``python3 -m benchmark.program_trace``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class Clock:
    """Stage timer: CUDA events on the card, the host clock (synchronized)
    elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"

    def time(self, fn: Callable, reps: int, setup: Optional[Callable] = None):
        """(median ms of ``fn(setup())`` over ``reps`` runs, the last result)."""
        import torch

        out, times = None, []
        for i in range(reps + 2):
            arg = setup() if setup is not None else None
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = fn(arg) if setup is not None else fn()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                t = time.perf_counter()
                out = fn(arg) if setup is not None else fn()
                ms = 1e3 * (time.perf_counter() - t)
            if i >= 2:
                times.append(ms)
        return statistics.median(times), out

    def kernels(self, fn: Callable, reps: int, setup: Optional[Callable] = None):
        """(device ms per run of ``fn``, its three largest kernels as (name,
        ms per run)) from ``torch.profiler``; (None, []) off the card."""
        if not self.cuda:
            return None, []
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        args = [setup() if setup is not None else None for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for arg in args:
                fn(arg) if setup is not None else fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3 / reps) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        return sum(ms for _, ms in rows), [(k[:60], round(ms, 4)) for k, ms in rows[:3]]


def stage_row(name: str, ms: float, device_ms=None, top=(), clock: str = "device") -> Dict:
    row = {"stage": name, "ms": round(ms, 4), "clock": clock}
    if device_ms is not None:
        row["kernels_ms"] = round(device_ms, 4)
        row["top_kernels"] = list(top)
    return row


def show(title: str, rows: List[Dict], card: str) -> None:
    print(f"{title} [{card}]")
    for r in rows:
        extra = ""
        if "kernels_ms" in r:
            extra += f"; device kernels {r['kernels_ms']:.3f} ms, largest {r['top_kernels']}"
        print(f"  {r['stage']:<26} {r['ms']:9.3f} ms ({r['clock']}){extra}")
    total = sum(r["ms"] for r in rows)
    print(f"  {'sum of the stages':<26} {total:9.3f} ms")


def profile_train(device, reps: int, clock: Clock, card: str) -> List[Dict]:
    import torch

    import chip_smoke
    from caesar_mrcnn_tpu_torch import weights as W
    from caesar_mrcnn_tpu_torch.data.generator import TrainingPipeline
    from caesar_mrcnn_tpu_torch.models.mask_rcnn import MaskRCNN
    from caesar_mrcnn_tpu_torch.train import trainer as T

    cfg = chip_smoke.train_config()
    with tempfile.TemporaryDirectory() as tmp:
        ds = chip_smoke.load_train_dataset(chip_smoke.write_train_dataset(tmp))
        pipe = TrainingPipeline(ds, cfg, seed=chip_smoke.SEED, augmentation=True, cache_bytes=1 << 30)
        batches = pipe.batches()
        host_ms, host_batches = [], []
        for _ in range(reps + 2):
            t = time.perf_counter()
            host_batches.append(next(batches))
            host_ms.append(1e3 * (time.perf_counter() - t))
    model = MaskRCNN(cfg)
    W.init_weights(model, torch.Generator().manual_seed(chip_smoke.SEED))
    chip_smoke.settle_random_weights(model)
    model.to(device)
    opt = T.make_optimizer(cfg, model, "all")
    anchors, rpn_std, cw = T._step_constants(model, pipe.anchors_normalized(), None)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    rows = [stage_row("host batch (pipeline)", statistics.median(host_ms[2:]), clock="host")]
    it = iter(host_batches * 4)

    ms, b = clock.time(lambda: T.batch_to_device(next(it), device), reps)
    rows.append(stage_row("batch_to_device", ms, *clock.kernels(lambda: T.batch_to_device(next(it), device), 5)))
    ms, molded = clock.time(lambda: T.mold_batch(b, cfg, anchors.shape[0]), reps)
    rows.append(stage_row("mold_batch", ms, *clock.kernels(lambda: T.mold_batch(b, cfg, anchors.shape[0]), 5)))

    def forward():
        opt.zero_grad()
        return T._forward_losses(model, molded, anchors, rpn_std, cw, None, gen)[0]

    ms, losses = clock.time(forward, reps)
    rows.append(stage_row("forward + losses", ms, *clock.kernels(forward, 3)))
    ms, _ = clock.time(lambda ls: ls["total_loss"].backward(), reps, setup=forward)
    rows.append(stage_row("backward", ms, *clock.kernels(lambda ls: ls["total_loss"].backward(), 3, setup=forward)))
    ms, _ = clock.time(opt.step, reps)
    rows.append(stage_row("optimizer (Adam)", ms, *clock.kernels(opt.step, 5)))
    show("profile: train step, training flagship (ResNet-101 256^2 batch 8 bf16 Adam, 2000 proposals, 512 ROIs, "
         "300 GT)", rows, card)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default); cpu rehearses the control flow only")
    p.add_argument("--out", default=os.path.join(REPO, "build", "profile_stages.json"))
    args = p.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("profile_stages_torch: no CUDA device (pass --device cpu to rehearse on the CPU)")
    from caesar_mrcnn_tpu_torch import kernel_bench

    card = kernel_bench.card() if args.device != "cpu" else "cpu rehearsal, host clocks: not device measurements"
    if args.device != "cpu":
        from caesar_mrcnn_tpu_torch.ops import _kernels

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        _kernels.load(_kernels.build()[0])
    clock = Clock(args.device)
    out = {"card": card}
    out["train"] = profile_train(args.device, args.reps, clock, card)
    if not clock.cuda:  # the host clock measured every stage
        for r in out["train"]:
            r["clock"] = "host"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"profile: written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
