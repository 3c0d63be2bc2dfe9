"""Counts of ECO-Lite Kinetics-400."""

from portbench.counts.shapes import forward_flops, k1_bytes  # noqa: F401
from portbench.reference.eco_lite_kinetics import net  # noqa: F401
