"""Seeded kernel cases, bounds and timing for the port's CUDA kernels.

``chip_smoke.py`` takes its kernel cases, its timer and its bounds from
here. Run as a script on the machine with the card, from the repository
root, it splits each NMS and ROIAlign-backward call into the device
kernels it launches (``torch.profiler``) and times the whole call (CUDA
events, median of :data:`REPS`), optionally beside another checkout of
the port:

    python3 -m caesar_mrcnn_tpu_torch.kernel_bench [--parent DIR] [--json PATH]

``--parent DIR`` loads ``DIR/caesar_mrcnn_tpu_torch`` as a second package
and measures both in turns (parent, change, change, parent) in one
process, on one card. A summary goes to stdout; ``--json PATH`` also
writes every record, with each call's full kernel split.

Its cases are seeded, and the boxes of one real flagship train step: the
RPN's boxes and scores before NMS and the sampled ROIs, which
``chip_smoke.py`` saves to ``build/train_step_boxes.pt`` (run it first).

Bounds: the least time the card could take for the work, the larger of the
bytes the function must move (each input read once, each output written
once) over the memory rate and the operations over the f32 rate outside the
tensor cores, at the published H100 SXM peaks (3.35 TB/s, 67 TFLOP/s).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations of one IoU test (4 min/max, 2 sub, 2 max, 1 mul for the
# intersection; 2 x (2 sub, 1 mul) for the areas; add, sub; div; compare)
NMS_OPS_PER_PAIR = 20

SEED = 0
REPS = 20  # timed calls per median
TRAIN_STEP_BOXES = Path(__file__).resolve().parent.parent / "build" / "train_step_boxes.pt"


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn: Callable, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn: Callable, reps: int) -> Dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, in ms, from a
    ``torch.profiler`` trace of ``reps`` calls (after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            out[evt.key[:90]] = us / 1000.0 / reps
    return out


# -------------------------------------------------------------------- cases


def nms_case(rng, b: int, n: int, classes: bool):
    """Seeded boxes in clusters of near-duplicates, with exact score ties,
    -inf (invalid) scores and zero boxes; optionally class-offset."""
    centers = rng.uniform(0.0, 0.85, (b, n // 8 + 1, 2))
    sizes = rng.uniform(0.01, 0.15, (b, n // 8 + 1, 2))
    pick = rng.randint(0, centers.shape[1], (b, n))
    c = np.take_along_axis(centers, pick[..., None], 1)
    s = np.take_along_axis(sizes, pick[..., None], 1)
    jitter = rng.uniform(-0.004, 0.004, (b, n, 4))
    boxes = np.concatenate([c, np.minimum(c + s, 1.0)], -1) + jitter
    boxes = np.clip(boxes, 0.0, 1.0)
    boxes[rng.rand(b, n) < 0.02] = 0.0
    scores = np.round(rng.uniform(0.0, 1.0, (b, n)), 3)  # exact ties
    scores[rng.rand(b, n) < 0.05] = -np.inf
    if classes:
        boxes = boxes + 2.0 * rng.randint(1, 4, (b, n, 1))
    return boxes.astype(np.float32), scores.astype(np.float32)


def roi_case(rng, b: int, n: int):
    """Boxes of every size (all four levels), border-touching and zero."""
    y1 = rng.uniform(0.0, 0.9, (b, n))
    x1 = rng.uniform(0.0, 0.9, (b, n))
    h = np.exp(rng.uniform(np.log(0.01), 0.0, (b, n)))
    w = h * np.exp(rng.uniform(-0.7, 0.7, (b, n)))
    boxes = np.stack([y1, x1, np.minimum(y1 + h, 1.0), np.minimum(x1 + w, 1.0)], -1)
    boxes[:, ::7, 0] = 0.0
    boxes[:, ::11, 3] = 1.0
    boxes[:, ::13] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, -5:] = 0.0
    return boxes.astype(np.float32)


# NMS: the detect path's RPN (1000 kept) and per-class detection NMS, the
# train path's RPN (2000 kept): (B, N, threshold, max_output, class offset)
NMS_CASES = ((8, 6000, 0.9, 1000, False), (8, 1000, 0.3, 300, True), (8, 6000, 0.9, 2000, False))
# ROIAlign backward at the train path's shapes: (B, N, pool, C), 256^2 pyramid
BACKWARD_CASES = ((8, 512, 7, 256), (8, 168, 14, 256))
TRAIN_LEVELS = [(s, s) for s in (64, 32, 16, 8)]


# ------------------------------------------------------------------- bounds


def _bound(nbytes: float, ops: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_pairs(scores, idx, valid, max_output: int) -> int:
    """The IoU tests greedy NMS needs on this data: each kept box against
    every later box up to the position at which the walk stops (the
    ``max_output``-th kept box, or the last box), from the result
    ``(idx, valid)`` of :func:`nms_padded` on ``scores``."""
    import torch

    b, n = scores.shape
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=order.device).expand(b, n))
    pos = torch.gather(rank, 1, idx.long())  # sorted position of each kept slot
    full = valid.sum(1) >= max_output
    stop = torch.where(full, pos.masked_fill(~valid, -1).amax(1) + 1, torch.full_like(pos[:, 0], n))
    return int(((stop[:, None] - 1 - pos) * valid).sum())


def nms_bound(b: int, n: int, max_output: int, pairs: int) -> Tuple[float, str]:
    """Boxes and scores read, indices and flags written; ``pairs`` IoU
    tests (:func:`nms_pairs`)."""
    return _bound(b * n * 20 + b * max_output * 5, pairs * NMS_OPS_PER_PAIR)


def roi_align_bound(b: int, level_shapes: Sequence[Tuple[int, int]], n: int, pool: int, c: int,
                    itemsize: int) -> Tuple[float, str]:
    """Levels and boxes read, [B, N, pool, pool, C] written; 4 products and
    3 sums per output element, plus the 3 weight products."""
    outputs = b * n * pool * pool * c
    levels = b * sum(h * w for h, w in level_shapes) * c
    return _bound((levels + outputs) * itemsize + b * n * 16, outputs * 10)


def roi_align_backward_bound(b: int, level_shapes: Sequence[Tuple[int, int]], n: int, pool: int, c: int,
                             itemsize: int) -> Tuple[float, str]:
    """grad_out and boxes read, the level gradients written in the dtype;
    4 products and 4 sums per grad_out element."""
    grads = b * n * pool * pool * c
    levels = b * sum(h * w for h, w in level_shapes) * c
    return _bound((grads + levels) * itemsize + b * n * 16, grads * 8)


def crop_and_resize_bound(b: int, r: int, ph: int, pw: int) -> Tuple[float, str]:
    """The four f32 taps of every sample of the assigned channels (the only
    mask bytes the function needs), boxes and assignment read, crops
    written; 3 lerps per sample."""
    samples = b * r * ph * pw
    return _bound(samples * 4 * 4 + b * r * 24 + samples * 4, samples * 12)


# --------------------------------------------------------------- the script


def load_tree(path: str, alias: str):
    """The port package of another checkout, imported as ``alias``."""
    init = Path(path).resolve() / "caesar_mrcnn_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def _cases(dev):
    import torch

    if not TRAIN_STEP_BOXES.exists():
        raise SystemExit(f"kernel_bench: no {TRAIN_STEP_BOXES}; python3 chip_smoke.py saves a train step's boxes there")
    step = torch.load(TRAIN_STEP_BOXES)
    rng = np.random.RandomState(SEED)
    nms = [(f"nms B={b} N={n} thr={thr} max_output={max_out}" + (" class offset" if classes else ""),
            *(torch.from_numpy(a).to(dev) for a in nms_case(rng, b, n, classes)), max_out, thr)
           for b, n, thr, max_out, classes in NMS_CASES]
    boxes, scores, max_out, thr = step["nms"]
    nms.append((f"nms train-step RPN B={boxes.shape[0]} N={boxes.shape[1]} thr={thr} max_output={max_out}",
                boxes.to(dev), scores.to(dev), max_out, thr))
    cases = [(name, "nms", inputs, None) for name, *inputs in nms]
    for b, n, pool, c in BACKWARD_CASES:
        for label, boxes in (("seeded", torch.from_numpy(roi_case(rng, b, n))), ("train-step", step["rois"][pool])):
            boxes = boxes.to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                grad = torch.from_numpy(rng.randn(b, n, pool, pool, c).astype(np.float32)).to(dev, dtype)
                name = f"roi_align_backward {label} {str(dtype)[6:]} B={b} N={n} pool={pool} C={c}"
                bound = roi_align_backward_bound(b, TRAIN_LEVELS, n, pool, c, grad.element_size())
                cases.append((name, "backward", (grad, boxes, TRAIN_LEVELS, (256, 256)), bound))
    return cases


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose port is measured beside this one")
    ap.add_argument("--json", help="write the records here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    trees = {"change": importlib.import_module("caesar_mrcnn_tpu_torch")}
    if args.parent:
        trees["parent"] = load_tree(args.parent, "parent_port")
    ops = {}
    for label, pkg in trees.items():
        nms = importlib.import_module(pkg.__name__ + ".ops.nms")
        roi = importlib.import_module(pkg.__name__ + ".ops.roi_align")
        ops[label] = {"nms": nms.nms_padded, "backward": roi.roi_align_backward}
    order = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    records = []
    for case, kind, inputs, bound in _cases(torch.device("cuda")):
        if kind == "nms":  # the pairs this data needs, from the change's result
            boxes, scores, max_out, _ = inputs
            pairs = nms_pairs(scores, *ops["change"]["nms"](*inputs), max_out)
            bound = nms_bound(*scores.shape, max_out, pairs)
        bound_ms, bound_by = bound
        rec = {"case": case, "bound_ms": bound_ms, "bound_by": bound_by, "ms": {k: [] for k in trees}}
        for label in order:
            fn = ops[label][kind]
            rec["ms"][label].append(median_ms(lambda: fn(*inputs), REPS))
        rec["split"] = {label: device_split(lambda: ops[label][kind](*inputs), REPS) for label in trees}
        for label in trees:
            split = rec["split"][label]
            top = sorted(split.items(), key=lambda kv: -kv[1])
            print(f"{case} [{label}]: {' / '.join(f'{t:.4f}' for t in rec['ms'][label])} ms (median of {REPS}, "
                  f"CUDA events); kernels {sum(split.values()):.4f} ms: "
                  + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top[:6])
                  + f"; bound {bound_ms:.4f} ms ({bound_by}) [{name}]")
        records.append(rec)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": name, "records": records}, indent=1))


if __name__ == "__main__":
    main()
