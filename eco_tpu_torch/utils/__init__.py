"""Shape arithmetic, copied from ``eco_tpu/utils/shapes.py``."""
