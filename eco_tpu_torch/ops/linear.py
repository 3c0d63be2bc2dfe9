"""InnerProduct (twin of ``eco_tpu/ops/linear.py``).

The weight is stored ``(D_out, D_in)`` as in Caffe and ``nn.Linear``; the
bridge transposes the reference's ``(D_in, D_out)``.  The product is rounded
to ``x.dtype`` before the bias is added in that type, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def inner_product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    """x: (N, D_in); w: (D_out, D_in); b: (D_out,)."""
    y = F.linear(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
