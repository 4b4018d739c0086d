"""The PyTorch port imports without JAX and names no JAX-package import."""

import ast
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ft8_demodulator_tpu_torch"
JAX_PACKAGE = REPO / "ft8_demodulator_tpu"
# names a port subpackage exports beyond the JAX package's: the geometry's
# waterfall constants module and the BP + CRC tail it feeds
PORT_ONLY = {"demod": {"SlotDecoder", "finish_decode"}}


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


def test_torch_subpackage_exports_match_jax():
    """Every subpackage of the JAX package (and the package itself): the
    port's ``__all__`` holds the same names (plus PORT_ONLY), and each of
    JAX's names imports from the port's subpackage with jax blocked."""
    subs = [""] + sorted(d.name for d in JAX_PACKAGE.iterdir()
                         if (d / "__init__.py").exists())
    want = {}
    for sub in subs:
        mod = importlib.import_module(
            ".".join(filter(None, ("ft8_demodulator_tpu", sub))))
        want[sub] = getattr(mod, "__all__", None)
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"want = json.loads({json.dumps(json.dumps(want))})\n"
        "out = {}\n"
        "for sub, names in want.items():\n"
        "    mod = '.'.join(filter(None, ('ft8_demodulator_tpu_torch', "
        "sub)))\n"
        "    if names:\n"
        "        exec(f'from {mod} import {\", \".join(names)}')\n"
        "    out[sub] = getattr(importlib.import_module(mod), '__all__', "
        "None)\n"
        "assert 'ft8_demodulator_tpu' not in sys.modules\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    for sub in subs:
        if want[sub] is None:
            assert got[sub] is None, sub
        else:
            assert len(got[sub]) == len(set(got[sub])), sub
            assert set(got[sub]) - PORT_ONLY.get(sub, set()) \
                == set(want[sub]), sub


def _parameters(path: Path, name: str) -> list[str]:
    """The parameter names of the module-level function ``name`` in
    ``path``, in order (read from the source: no import)."""
    tree = ast.parse(path.read_text())
    fn, = (n for n in tree.body
           if isinstance(n, ast.FunctionDef) and n.name == name)
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


# (module, function, the port's parameters for JAX's): the public
# signatures that take what JAX's take, each known difference written out
SAME = {"demod/decode.py": ["finish_decode", "mf_retry", "coherent_retry",
                            "variant_retry", "ap_retry_llrs",
                            "decode_waterfall", "decode_waterfall_mf",
                            "decode_slot", "decode_slots"],
        "ops/llr.py": ["extract_llrs", "extract_llrs_tf",
                       "extract_llrs_matched_grid"],
        "ops/ldpc_decode.py": ["bp_decode_batch", "bp_decode",
                               "ldpc_check"]}
SIGNATURES = [(mod, fn, {}) for mod, fns in SAME.items() for fn in fns] + [
    ("parallel/tensor.py", "decode_slot_tp", {"+": ["device"]}),
    ("demod/stack.py", "decode_slot_stacked", {"+": ["device"]}),
    ("ops/llr.py", "extract_llrs_matched_blocks",
     {"spec_re": "spec", "spec_im": None}),
    ("ops/llr.py", "extract_llrs_matched_blocks_stacked",
     {"spec_re": "spec", "spec_im": None}),
    ("ops/osd.py", "osd_decode_batch", {"force_jnp": None}),
    ("ops/osd.py", "osd_decode_masked", {"force_jnp": None}),
]


@pytest.mark.parametrize("module,name,known", SIGNATURES,
                         ids=[f"{m}:{f}" for m, f, _ in SIGNATURES])
def test_public_signature_matches_jax(module, name, known):
    """The port's parameter list is the JAX function's, name for name,
    apart from the differences written out: a renamed (``spec`` for
    ``spec_re``) or dropped (``spec_im``, OSD's ``force_jnp``) JAX
    parameter, and the port's own trailing ``device``."""
    want = [known.get(p, p) for p in _parameters(JAX_PACKAGE / module, name)]
    want = [p for p in want if p is not None] + known.get("+", [])
    assert _parameters(PORT / module, name) == want


# the kernel wrappers and the private helpers that receive a table their op
# resolved: the only functions that take a constant as an argument
TABLE_TAKERS = {"_bp_iteration", "_mixes"}


def test_no_function_above_the_kernel_wrappers_takes_a_constant():
    """No function of the port outside ``ops/*_cuda.py`` has a parameter
    named ``decoder``, ``gray_map``, ``crc_t`` or ``tables``, besides the
    private helpers of TABLE_TAKERS."""
    offenders = []
    for path in PORT.rglob("*.py"):
        if path.parent.name == "ops" and path.stem.endswith("_cuda"):
            continue
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name not in TABLE_TAKERS:
                a = fn.args
                names = {p.arg for p in a.posonlyargs + a.args
                         + a.kwonlyargs}
                for bad in names & {"decoder", "gray_map", "crc_t",
                                    "tables"}:
                    offenders.append(f"{path.relative_to(REPO)}:"
                                     f"{fn.name}({bad})")
    assert offenders == []
