"""The examples/ scripts stay runnable (tiny configs, CPU backend)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}


def _run(args):
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_fountain_render_example(tmp_path):
    out = _run(["examples/fountain_render.py", str(tmp_path), "12"])
    assert "done:" in out
    pngs = [p for p in os.listdir(tmp_path) if p.endswith(".png")]
    assert pngs, out


def test_nbody_demo_example():
    out = _run(["examples/nbody_demo.py", "4000", "3"])
    assert "final state" in out
    assert "alive" in out
