"""What the benchmark loads: a whole small run of the harness in a fresh
process loads no module whose top-level name is ``jax``, ``jaxlib``,
``flax``, ``optax``, ``orbax`` or ``caesar_mrcnn_tpu`` (the port's name
begins with the JAX package's, so names are compared whole), and the
reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "caesar_mrcnn_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {tests!r})
from conftest import small_cell, CELL
from benchmark import run as R
config, traffic = small_cell()
res = R.run_cell(CELL, 2**31 + 9, 2.0, False, device="cpu", config=config, traffic=traffic)
print(json.dumps({{"correct": res["correct"], "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE = """
import json, sys
import benchmark.reference.judge_detect, benchmark.reference.mrcnn, benchmark.bounds, benchmark.flops
import benchmark.weights, benchmark.trace
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    res = _python(RUN.format(tests=os.path.dirname(os.path.abspath(__file__))))
    assert res["correct"]
    assert "caesar_mrcnn_tpu_torch" in res["modules"]
    assert not FORBIDDEN & set(res["modules"])


def test_the_reference_and_yardstick_load_nothing_of_the_port():
    modules = set(_python(REFERENCE))
    assert "caesar_mrcnn_tpu_torch" not in modules and not FORBIDDEN & modules
