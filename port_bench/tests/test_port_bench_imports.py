"""Nothing the harness loads is JAX or the JAX package, and the plain
reference loads nothing of the program either (top-level module names,
compared whole: the program's name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

# a finder that refuses jax and the JAX package, so that an import of either
# fails loudly instead of loading
_BLOCK = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "ft8_demodulator_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, %r)
"""


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK % str(ROOT) + code
         + "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
           "for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = """
import importlib, importlib.util, pathlib
pb = pathlib.Path(%r) / "port_bench"
for path in sorted(pb.rglob("*.py")):
    rel = path.relative_to(pb.parent)
    if "tests" in rel.parts:
        continue
    if path.parent.name in ("metrics", "end_to_end"):
        spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts).replace(".__init__", ""))
# what the entries load at run time
import ft8_demodulator_tpu_torch.demod.decode
import ft8_demodulator_tpu_torch.ops.waterfall
""" % str(ROOT)
    loaded = _modules_after(code)
    assert "port_bench" in loaded and "ft8_demodulator_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ft8_demodulator_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after(
        "import port_bench.reference.decode, port_bench.reference.tx, "
        "port_bench.generator, port_bench.bounds, port_bench.compare")
    assert "port_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ft8_demodulator_tpu",
                         "ft8_demodulator_tpu_torch"}
