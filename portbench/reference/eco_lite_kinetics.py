"""ECO-Lite, Kinetics-400 (``models_ECO_Lite/kinetics/ECO_Lite.prototxt``)."""

from portbench.reference import eco
from portbench.reference.eco import clips, forward, param_specs  # noqa: F401


def net(cfg: dict) -> list:
    return eco.layers("lite", cfg["num_classes"], cfg["fc_name"], cfg["dropout_ratio"],
                      cfg["num_segments"])
