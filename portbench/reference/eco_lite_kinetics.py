"""ECO-Lite, Kinetics-400 (``models_ECO_Lite/kinetics/ECO_Lite.prototxt``)."""

from portbench.reference import eco


def net(cfg: dict) -> list:
    return eco.layers("lite", cfg["num_classes"], cfg["fc_name"], cfg["dropout_ratio"],
                      cfg["num_segments"])
