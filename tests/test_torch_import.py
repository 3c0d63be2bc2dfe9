"""eco_tpu_torch never imports JAX, nor the JAX package ``eco_tpu``: the
machine with the GPU has no JAX, and the port keeps its own copies of what it
needs.

Each case imports in a fresh interpreter where ``import jax`` and ``import
eco_tpu`` fail (``sys.modules[name] = None``), so an import of either
anywhere below the imported modules raises.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil
import eco_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eco_tpu_torch.__path__, "eco_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 23, names
assert {"eco_tpu_torch.ops.quant", "eco_tpu_torch.ops.qconv",
        "eco_tpu_torch.convert.quantize", "eco_tpu_torch.spec.graph",
        "eco_tpu_torch.spec.prototxt", "eco_tpu_torch.models.zoo",
        "eco_tpu_torch.utils.shapes"} <= set(names), names
"""

_IMPORT_CHIP_SMOKE = """
import chip_smoke
assert callable(chip_smoke.main)
"""


@pytest.mark.parametrize("code", [_IMPORT_ALL, _IMPORT_CHIP_SMOKE],
                         ids=["package_and_submodules", "chip_smoke"])
def test_imports_without_jax(code):
    prelude = "import sys\nsys.modules['jax'] = None\nsys.modules['eco_tpu'] = None\n"
    check = ("\nassert sys.modules.get('jax') is None and sys.modules.get('eco_tpu') is None"
             "\nassert not [m for m in sys.modules if m.startswith(('jax.', 'eco_tpu.'))]"
             "\nprint('ok')\n")
    proc = subprocess.run(
        [sys.executable, "-c", prelude + code + check],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
