"""The PyTorch port imports without JAX and names no JAX-package import."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ft8_demodulator_tpu_torch"


def test_torch_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import ft8_demodulator_tpu_torch.beacon\n"
        "import ft8_demodulator_tpu_torch.beacon.detect\n"
        "import ft8_demodulator_tpu_torch.beacon.drift\n"
        "import ft8_demodulator_tpu_torch.config\n"
        "import ft8_demodulator_tpu_torch.demod\n"
        "import ft8_demodulator_tpu_torch.demod.beacon_session\n"
        "import ft8_demodulator_tpu_torch.demod.decode\n"
        "import ft8_demodulator_tpu_torch.demod.stack\n"
        "import ft8_demodulator_tpu_torch.ops.gfsk\n"
        "import ft8_demodulator_tpu_torch.ops.llr\n"
        "import ft8_demodulator_tpu_torch.ops.osd\n"
        "import ft8_demodulator_tpu_torch.ops.osd_cuda\n"
        "import ft8_demodulator_tpu_torch.ops.subtract\n"
        "import ft8_demodulator_tpu_torch.ops.sync_cuda\n"
        "import ft8_demodulator_tpu_torch.ops.waterfall_cuda\n"
        "import ft8_demodulator_tpu_torch.protocol.message\n"
        "import ft8_demodulator_tpu_torch.utils.metrics\n"
        "import ft8_demodulator_tpu_torch.channel\n"
        "import ft8_demodulator_tpu_torch.channel.channel\n"
        "import ft8_demodulator_tpu_torch.channel.doppler\n"
        "import ft8_demodulator_tpu_torch.channel.geodesy\n"
        "import ft8_demodulator_tpu_torch.channel.geomodel\n"
        "import ft8_demodulator_tpu_torch.channel.sgp4\n"
        "import ft8_demodulator_tpu_torch.io\n"
        "import ft8_demodulator_tpu_torch.io.sdr\n"
        "import ft8_demodulator_tpu_torch.io.wav\n"
        "import ft8_demodulator_tpu_torch.demod.stream_session\n"
        "import ft8_demodulator_tpu_torch.compat\n"
        "import ft8_demodulator_tpu_torch.cli\n"
        "import ft8_demodulator_tpu_torch.plotting\n"
        "import ft8_demodulator_tpu_torch.utils.debug\n"
        "import ft8_demodulator_tpu_torch.utils.profiling\n"
        "import ft8_demodulator_tpu_torch.examples.satellite_beacon_demo\n"
        "import ft8_demodulator_tpu_torch.parallel\n"
        "import ft8_demodulator_tpu_torch.parallel.collectives\n"
        "import ft8_demodulator_tpu_torch.parallel.composed\n"
        "import ft8_demodulator_tpu_torch.parallel.dryrun\n"
        "import ft8_demodulator_tpu_torch.parallel.launch\n"
        "import ft8_demodulator_tpu_torch.parallel.mesh\n"
        "import ft8_demodulator_tpu_torch.parallel.pipeline\n"
        "import ft8_demodulator_tpu_torch.parallel.streaming\n"
        "import ft8_demodulator_tpu_torch.parallel.tensor\n"
        "assert 'ft8_demodulator_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_torch_port_imports_from_a_copy_of_its_package_alone(tmp_path):
    """The port's package copied alone (no ft8_demodulator_tpu/ beside it)
    imports with jax blocked: it loads no file of the JAX package."""
    shutil.copytree(PORT, tmp_path / PORT.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import ft8_demodulator_tpu_torch.protocol.constants as C\n"
        "import ft8_demodulator_tpu_torch.ops.sync_cuda\n"
        "from ft8_demodulator_tpu_torch.beacon import correct_frequency_drift"
        ", track_known_payload\n"
        "from ft8_demodulator_tpu_torch.demod import BeaconSession, "
        "decode_ft8_stacked\n"
        "from ft8_demodulator_tpu_torch.protocol import message\n"
        "from ft8_demodulator_tpu_torch import cli, compat, plotting\n"
        "from ft8_demodulator_tpu_torch.channel import Channel, "
        "apply_doppler_physical\n"
        "from ft8_demodulator_tpu_torch.demod.stream_session import "
        "StreamSession\n"
        "from ft8_demodulator_tpu_torch.examples import "
        "satellite_beacon_demo\n"
        "from ft8_demodulator_tpu_torch.io import read_wave_file, sdr\n"
        "from ft8_demodulator_tpu_torch.utils import debug, profiling\n"
        "from ft8_demodulator_tpu_torch.parallel import (collectives, "
        "composed, dryrun, launch, mesh, pipeline, streaming, tensor)\n"
        "from ft8_demodulator_tpu_torch.parallel import __all__ as names\n"
        "assert len(names) == 10\n"
        "assert C.LDPC_GENERATOR.shape == (83, 91)\n"
        "assert message.unpack_message(message.pack_message("
        "'CQ K1ABC FN42')) == 'CQ K1ABC FN42'\n"
        "assert not any(m == 'ft8_demodulator_tpu' or m.startswith("
        "'ft8_demodulator_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert not (tmp_path / "ft8_demodulator_tpu").exists()
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_torch_port_names_no_jax_package_import():
    """No module of the port imports jax or the JAX package; it keeps its
    own copies of the numpy-only modules it needs (protocol/_ldpc_data.py)
    and reads no file of the JAX package by path."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax\b|ft8_demodulator_tpu(?!_torch)\b)",
        re.MULTILINE)
    by_path = re.compile(r"""["']ft8_demodulator_tpu["']|spec_from_file""")
    offenders = [str(path.relative_to(REPO))
                 for path in PORT.rglob("*.py")
                 if pattern.search(path.read_text())
                 or by_path.search(path.read_text())]
    assert offenders == []
