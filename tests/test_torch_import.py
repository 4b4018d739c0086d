"""The PyTorch port imports without JAX and names no JAX-package import."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ft8_demodulator_tpu_torch"


def test_torch_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import ft8_demodulator_tpu_torch.config\n"
        "import ft8_demodulator_tpu_torch.demod\n"
        "import ft8_demodulator_tpu_torch.demod.decode\n"
        "import ft8_demodulator_tpu_torch.ops.osd\n"
        "import ft8_demodulator_tpu_torch.ops.osd_cuda\n"
        "import ft8_demodulator_tpu_torch.ops.subtract\n"
        "import ft8_demodulator_tpu_torch.ops.sync_cuda\n"
        "import ft8_demodulator_tpu_torch.ops.waterfall_cuda\n"
        "import ft8_demodulator_tpu_torch.utils.metrics\n"
        "assert 'ft8_demodulator_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_torch_port_names_no_jax_package_import():
    """No module of the port imports jax or the JAX package; the LDPC
    tables are read by file path (protocol/constants.py)."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax\b|ft8_demodulator_tpu(?!_torch)\b)",
        re.MULTILINE)
    offenders = [str(path.relative_to(REPO))
                 for path in PORT.rglob("*.py")
                 if pattern.search(path.read_text())]
    assert offenders == []
