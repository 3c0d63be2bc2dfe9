"""eco_tpu_torch never imports JAX: the machine with the GPU has none.

Each case imports in a fresh interpreter where ``import jax`` fails
(``sys.modules["jax"] = None``), so an import of JAX anywhere below the
imported modules raises.
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
        "eco_tpu_torch.convert.quantize"} <= set(names), names
"""

_IMPORT_CHIP_SMOKE = """
import chip_smoke
assert callable(chip_smoke.main)
"""


@pytest.mark.parametrize("code", [_IMPORT_ALL, _IMPORT_CHIP_SMOKE],
                         ids=["package_and_submodules", "chip_smoke"])
def test_imports_without_jax(code):
    prelude = "import sys\nsys.modules['jax'] = None\n"
    check = "\nassert sys.modules.get('jax') is None\nprint('ok')\n"
    proc = subprocess.run(
        [sys.executable, "-c", prelude + code + check],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
