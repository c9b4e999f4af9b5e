"""Host time of one call into a Python kernel through PyTorch's dispatcher,
by the two ways ``torch.library`` registers one, beside a direct call; and,
on the card, the port's own ``conv2d_int8`` call split into its layers.

Run from the repository root:

    python3 tools/dispatch_overhead.py [--card]

Without ``--card`` it launches nothing on a card (the numbers are the
host's): three operators with ``conv2d_int8``'s schema (``ops/library.py``)
and a body that returns a preallocated tensor, so only the way in is
timed: one defined with ``torch.library.Library(..., "DEF")`` and
``.impl(..., "CPU")`` (as the port registers its kernels), one with the
``torch.library.custom_op`` decorator, and the body called directly, on
the serving flagship's ``fpn/c5p5`` shapes (CPU tensors).

With ``--card`` it adds, on CUDA tensors at the same shapes: the trivial
``Library`` operator registered for CUDA; and the port's ``conv2d_int8``
(the Hopper kernel launched each time) called as the graph calls it (the
wrapper ``ops.quant.conv2d_int8``), as the operator (``torch.ops.caesar``
packet and overload), as its CUDA implementation directly, and the
wrapper's checks alone; then ``cProfile``'s top entries over 2,000
wrapper calls. Each call is made 20,000 times (2,000 for the kernel, with
a synchronize every 200 so the launch queue never fills) after warm-up
calls, in two rounds; microseconds per call, host clock.
"""

from __future__ import annotations

import argparse
import cProfile
import platform
import pstats
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
SCHEMA = ("(Tensor x, Tensor w, Tensor? sw, Tensor? b, int stride, int[] pads, bool relu, float? s_next, "
          "str? route) -> Tensor")


def _time(fn, n: int, sync_every: int = 0) -> float:
    for _ in range(min(n, 500)):
        fn()
    if sync_every:
        torch.cuda.synchronize()
    total = 0.0
    for start in range(0, n, sync_every or n):
        t = time.perf_counter()
        for _ in range(min(sync_every or n, n - start)):
            fn()
        total += time.perf_counter() - t
        if sync_every:
            torch.cuda.synchronize()
    return total / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", action="store_true", help="also time the port's conv2d_int8 call on the card")
    args = ap.parse_args()
    out = torch.zeros(1)  # small, so that the custom_op's clone costs next to nothing

    def body(x, w, sw, b, stride, pads, relu, s_next, route):
        return out

    lib = torch.library.Library("dispatch_overhead", "DEF")
    lib.define("conv" + SCHEMA)
    lib.impl("conv", body, "CPU")
    lib.impl("conv", body, "CUDA")

    @torch.library.custom_op("dispatch_overhead_custom::conv", mutates_args=())
    def custom(x: torch.Tensor, w: torch.Tensor, sw: Optional[torch.Tensor], b: Optional[torch.Tensor], stride: int,
               pads: List[int], relu: bool, s_next: Optional[float], route: Optional[str]) -> torch.Tensor:
        return out.clone()  # a custom_op's output may not alias a tensor it keeps

    def body_clone(*a):
        return body(*a).clone()

    def inputs(device):
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randint(-127, 128, (8, 16, 16, 2048), generator=gen, device=device, dtype=torch.int8)
        w = torch.randint(-127, 128, (256, 1, 1, 2048), generator=gen, device=device, dtype=torch.int8)
        return x, w, torch.rand(256, generator=gen, device=device) * 1e-3, torch.zeros(256, device=device)

    cpu = inputs("cpu") + (1, [0, 0, 0, 0], False, None, None)
    calls = {
        "direct call of the body": (lambda: body(*cpu), 20000, 0),
        "direct call of the body with the custom_op's clone": (lambda: body_clone(*cpu), 20000, 0),
        "Library DEF + impl (the port's way)": (lambda: torch.ops.dispatch_overhead.conv(*cpu), 20000, 0),
        "custom_op decorator": (lambda: torch.ops.dispatch_overhead_custom.conv(*cpu), 20000, 0),
    }
    header = f"host: {platform.processor() or platform.machine()}, python {platform.python_version()}, " \
             f"torch {torch.__version__}"
    wrapper = None
    if args.card:
        if not torch.cuda.is_available():
            raise SystemExit("dispatch_overhead --card: no CUDA device")
        sys.path.insert(0, str(ROOT))
        from caesar_mrcnn_tpu_torch.ops import library as L
        from caesar_mrcnn_tpu_torch.ops import quant as Q

        x, w, sw, b = inputs("cuda")
        card = (x, w, sw, b, 1, [0, 0, 0, 0], False, None, None)
        pads = ((0, 0), (0, 0))

        def wrapper():
            return Q.conv2d_int8(x, w, sw, b, 1, pads)

        calls.update({
            "Library DEF + impl, CUDA tensors": (lambda: torch.ops.dispatch_overhead.conv(*card), 20000, 0),
            "conv2d_int8 wrapper (the graph's call)": (wrapper, 2000, 200),
            "torch.ops.caesar.conv2d_int8 packet": (lambda: L.ops.conv2d_int8(*card), 2000, 200),
            "torch.ops.caesar.conv2d_int8.default overload": (lambda: L.ops.conv2d_int8.default(*card), 2000, 200),
            "the CUDA implementation called directly": (lambda: L._conv2d_int8_cuda(*card), 2000, 200),
            "the wrapper's checks alone": (lambda: Q._check_conv(x, w, 1, pads, sw, b), 20000, 0),
        })
        header += f", {torch.cuda.get_device_name(0)}"
    print(header)
    for rnd in range(2):
        for name, (fn, n, sync_every) in calls.items():
            print(f"round {rnd}: {name}: {_time(fn, n, sync_every):.2f} us per call", flush=True)
    if wrapper is not None:
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(10):
            for _ in range(200):
                wrapper()
            torch.cuda.synchronize()
        prof.disable()
        pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime").print_stats(15)


if __name__ == "__main__":
    main()
