"""The model zoo, shared with ``eco_tpu``.

The builders emit GraphSpec IR and hold no framework code, so the port runs
the reference's own graphs rather than copies of them.
"""

from eco_tpu.models import REGISTRY, build_eco_full, build_eco_lite, get_model

__all__ = ["REGISTRY", "build_eco_full", "build_eco_lite", "get_model"]
