"""The yardstick of the int8 kernels' rooflines: the least time an int8
convolution or a quantizer pass could take for its work, on one NVIDIA
H100 SXM (``bounds.py``'s published peaks: 3.35 TB/s, 1,979 dense int8
TOPS, 67 TFLOP/s f32).

Frozen copies of ``caesar_mrcnn_tpu_torch/kernel_bench.py``'s
``conv_int8_bound`` (with ``ConvSite``'s ``out_hw``, ``read_hw``, ``m``,
``kdim`` and ``ops``) and ``quantize_bound``, so that a change to the
program cannot move the benchmark's yardstick. They take the shapes of
the calls themselves, as :func:`conv_call` and :func:`quantize_call`
record them at the program's call sites (the stem's input as the kernel
gets it, its 3 channels padded to 16):

* a convolution: the int8 input that its taps touch, the int8 weights
  read once and the output written once (f32, or int8 where it requantizes
  for the next convolution), over the memory rate, against a multiply and
  an add per (output pixel, filter, tap) over the int8 rate; the larger;
* a quantizer pass: its float input read and its int8 output written
  (with any padded channels), against a division, a rounding and two
  clamps per value in f32; the larger.
"""

from __future__ import annotations

import functools
from typing import Dict

from .bounds import PEAK_BYTES_PER_S, PEAK_INT8_PER_S, _bound


def conv_call(xq, w, sw, b, stride, pads, relu=False, s_next=None, route=None) -> Dict:
    """What the bound needs of one ``conv2d_int8`` call (its arguments)."""
    return {"x": tuple(int(v) for v in xq.shape), "w": tuple(int(v) for v in w.shape), "stride": int(stride),
            "pads": tuple(tuple(int(v) for v in p) for p in pads), "int8_out": s_next is not None}


def quantize_call(x, s_in, channels=None) -> Dict:
    """What the bound needs of one ``quantize_int8`` call (its arguments)."""
    n = x.numel()
    c = x.shape[-1] if x.dim() else 1
    return {"n": int(n), "itemsize": x.element_size(), "n_out": int(n // c * channels if channels else n)}


@functools.lru_cache(maxsize=1024)
def _touched(n_in: int, n_out: int, lo: int, stride: int, k: int) -> int:
    """Input rows (or columns) that some tap reads."""
    return len({o * stride - lo + t for o in range(n_out) for t in range(k)} & set(range(n_in)))


def conv_int8_bound(call: Dict) -> float:
    """Least ms of one int8 convolution (see the module's docstring)."""
    batch, h, w, cin = call["x"]
    cout, k = call["w"][0], call["w"][1]
    (pt, pb), (pl, pr) = call["pads"]
    s = call["stride"]
    ho, wo = (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1
    rows, cols = _touched(h, ho, pt, s, k), _touched(w, wo, pl, s, k)
    m, kdim = batch * ho * wo, k * k * cin
    nbytes = batch * rows * cols * cin + cout * kdim + m * cout * (1 if call["int8_out"] else 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, 2 * m * cout * kdim / PEAK_INT8_PER_S * 1e3
    return max(t_bytes, t_ops)


def quantize_bound(call: Dict) -> float:
    """Least ms of one quantizer pass (see the module's docstring)."""
    return _bound(call["n"] * call["itemsize"] + call["n_out"], call["n"] * 4)[0]
