"""The model zoo: GraphSpec builders, copied from ``eco_tpu/models``.

The builders hold no framework code; the port keeps its own copy so that it
never imports ``eco_tpu``.  ``tests/test_torch_spec.py`` holds every builder's
``graph_to_json`` equal to the reference's.  I3D (``models/i3d.py``), Video
Swin (``models/video_swin.py``) and MViTv2 (``models/mvit.py``) are the
port's own, each held to its plain reference in ``tests/``.
"""

from eco_tpu_torch.models.eco import build_eco_full, build_eco_lite
from eco_tpu_torch.models.i3d import build_i3d
from eco_tpu_torch.models.zoo import REGISTRY, get_model

__all__ = ["REGISTRY", "build_eco_full", "build_eco_lite", "build_i3d", "get_model"]
