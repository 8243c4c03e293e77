"""A run loads no module of JAX or the JAX package, and the reference
none of the program either (top-level names compared whole: the port's
name begins with the JAX package's)."""

import subprocess
import sys

from lbm_bench.bench import ROOT

RUN = """
import sys, time
from lbm_bench.bench import run_cell, forbidden_modules
from lbm_bench.tests.support import CpuSystem, SMALL
for cell in SMALL:
    res, _ = run_cell(cell, 3, 0, 1, CpuSystem(), time.perf_counter(), overrides=SMALL[cell])
    assert res["correct"], cell
print(sorted({m.split('.')[0] for m in sys.modules}))
print("FORBIDDEN", forbidden_modules())
"""

REFERENCE = """
import sys
import lbm_bench.reference.lbm, lbm_bench.inputs, lbm_bench.roofline
print("TOP", sorted({m.split('.')[0] for m in sys.modules}))
"""


def python(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    out = python(RUN)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "xlb_tpu_torch" in out.stdout  # the port itself was loaded: the check is not vacuous


def test_the_reference_loads_neither_jax_nor_the_program():
    out = python(REFERENCE)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.split("TOP", 1)[1])
    assert not {"jax", "jaxlib", "flax", "xlb_tpu", "xlb_tpu_torch"} & set(tops)
