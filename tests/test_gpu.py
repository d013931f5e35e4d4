"""Card-only checks: they skip on the CPU and run on a GPU with
``python -m pytest tests/ -q -m gpu``.

The test process itself stays on the CPU (``tests/conftest.py``), so each
check runs in a child process that has the card to itself; whether there is
a card is decided by the fixture, when the test runs.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_ENV = {k: v for k, v in os.environ.items()
             if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


def _child(code: str, timeout: int = 900) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=CHILD_ENV, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def gpu():
    try:
        platform = _child("import jax; print(jax.devices()[0].platform)",
                          timeout=300)
    except AssertionError:
        platform = None
    if platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these checks "
                    "on the card)")


@pytest.mark.gpu
def test_compiled_kernel_matches_dense(gpu):
    """The Triton-compiled kernel against the dense pass after warm frames:
    exact flags, accelerations within ``chip_smoke.ACC_TOL``."""
    rep = json.loads(_child(
        "import json, jax, chip_smoke\n"
        "from particlesystem_tpu import NBodyConfig\n"
        "from particlesystem_tpu.api import NBodySimulation\n"
        "cfg = NBodyConfig(n_fill=1 << 16)\n"
        "sim = NBodySimulation(cfg)\n"
        "sim.run(10)\n"
        "rep = chip_smoke.kernel_vs_dense(cfg, chip_smoke.active_state(sim),"
        " '64k', chip_smoke.CompileClock(jax))\n"
        "print(json.dumps(rep))\n"))
    assert rep["triton_call"] and not rep["interpret"]
    assert rep["acc_err_over_max"] <= 1e-5
