"""Counts of ECO-Full Kinetics-400."""

from portbench.counts.shapes import forward_flops, k1_bytes  # noqa: F401
from portbench.reference.eco_full_kinetics import net  # noqa: F401
