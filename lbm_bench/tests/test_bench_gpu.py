"""On the card: one short run of a cell through the command line, as the
benchmark's check runs it. Skips without a CUDA card (decided in the
fixture, not at import)."""

import json
import subprocess
import sys

import pytest

from lbm_bench.bench import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(card, trace):
    out = subprocess.run([sys.executable, "-m", "lbm_bench.run", "--workload", "sphere_open.window.f32",
                          "--seed", str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    expected = {"fwd.stream_roofline", "fwd.device_idle"} if trace else {"mlups", "setup_s"}
    assert expected <= set(result["metrics"])
