"""The port stands alone: importing it loads neither jax nor the JAX
package, and a CUDA request on a machine without a card fails instead of
running on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import dashing2_tpu_torch, dashing2_tpu_torch.cli
import dashing2_tpu_torch.cmp.core, dashing2_tpu_torch.sketch.core
import dashing2_tpu_torch.io.emitters, dashing2_tpu_torch.ops.nibble_tri
import dashing2_tpu_torch.ops.nibble_comb, dashing2_tpu_torch.cmp.estimators
import dashing2_tpu_torch.ops.gtlt, dashing2_tpu_torch.ops.cmp_kernels
import dashing2_tpu_torch.ops.int_counts
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "dashing2_tpu."))
             or m == "dashing2_tpu")
print(bad)
assert not bad, bad
assert "triton" not in sys.modules
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _cuda_job_without_card(tmp_path, flags):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fa = tmp_path / "a.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    out = tmp_path / "out.bin"
    r = subprocess.run(
        [sys.executable, "-m", "dashing2_tpu_torch", "sketch", "-k", "31",
         "-S", "64"] + flags + ["--binary-output", "--cmpout", str(out),
                                str(fa), str(fa)],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
    assert not out.exists()


def test_cli_default_cuda_device_fails_without_a_card(tmp_path):
    _cuda_job_without_card(tmp_path, ["--fastcmp", "0.5", "--bbit-sigs"])


def test_full_register_job_on_cuda_fails_without_a_card(tmp_path):
    """The default job (no --fastcmp) with the default --device cuda."""
    _cuda_job_without_card(tmp_path, [])
