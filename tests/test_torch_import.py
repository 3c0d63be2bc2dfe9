"""eco_tpu_torch never imports JAX, nor the JAX package ``eco_tpu``: the
machine with the GPU has no JAX, and the port keeps its own copies of what it
needs.  Nor does it need ``cv2`` or ``h5py`` to import: both are optional,
and the data planes and apps import them only where they are used.

Each case imports in a fresh interpreter where ``import jax`` and ``import
eco_tpu`` fail (``sys.modules[name] = None``), and in the second test
``import cv2`` and ``import h5py`` too, so an import of any of them anywhere
below the imported modules raises.
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
assert len(names) >= 67, names
assert {"eco_tpu_torch.ops.quant", "eco_tpu_torch.ops.qconv",
        "eco_tpu_torch.convert.quantize", "eco_tpu_torch.spec.graph",
        "eco_tpu_torch.spec.prototxt", "eco_tpu_torch.models.zoo",
        "eco_tpu_torch.utils.shapes", "eco_tpu_torch.data.pipeline",
        "eco_tpu_torch.data.device_prefetch", "eco_tpu_torch.apps.online",
        "eco_tpu_torch.apps.tsn_eval", "eco_tpu_torch.convert.caffemodel",
        "eco_tpu_torch.runtime.memory", "eco_tpu_torch.runtime.profiler",
        "eco_tpu_torch.ops.resize", "eco_tpu_torch.convert.write",
        "eco_tpu_torch.tools.cli", "eco_tpu_torch.tools.memreport",
        "eco_tpu_torch.tools.datasets", "eco_tpu_torch.tools.logparse",
        "eco_tpu_torch.tools.draw"} <= set(names), names
"""

_IMPORT_CHIP_SMOKE = """
import chip_smoke
assert callable(chip_smoke.main)
"""


def _import_with_blocked(code, blocked):
    prelude = "import sys\n" + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
    check = (f"\nassert all(sys.modules.get(m) is None for m in {blocked!r})"
             f"\nassert not [m for m in sys.modules if m.startswith({tuple(m + '.' for m in blocked)!r})]"
             "\nprint('ok')\n")
    proc = subprocess.run(
        [sys.executable, "-c", prelude + code + check],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("code", [_IMPORT_ALL, _IMPORT_CHIP_SMOKE],
                         ids=["package_and_submodules", "chip_smoke"])
def test_imports_without_jax(code):
    _import_with_blocked(code, ("jax", "eco_tpu"))


@pytest.mark.parametrize("code", [_IMPORT_ALL, _IMPORT_CHIP_SMOKE],
                         ids=["package_and_submodules", "chip_smoke"])
def test_imports_without_jax_cv2_or_h5py(code):
    """``cv2`` and ``h5py`` are optional: a machine may have neither."""
    _import_with_blocked(code, ("jax", "eco_tpu", "cv2", "h5py"))
