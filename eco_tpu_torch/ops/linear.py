"""InnerProduct (twin of ``eco_tpu/ops/linear.py``).

The weight is stored ``(D_out, D_in)`` as in Caffe and ``nn.Linear``; the
bridge transposes the reference's ``(D_in, D_out)``.  The product is rounded
to ``x.dtype`` before the bias is added in that type, as in the reference.
Spans (``utils/tracing.py``): ``eco.cast`` around the weight's cast,
``eco.bias`` around the bias's cast and add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.tracing import span


def inner_product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    """x: (..., D_in), the rows of the product along its leading axes;
    w: (D_out, D_in); b: (D_out,)."""
    with span("eco.cast"):
        w = w.to(x.dtype)
    y = F.linear(x, w)
    if b is not None:
        with span("eco.bias"):
            y = y + b.to(y.dtype)
    return y
