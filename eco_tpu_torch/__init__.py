"""ECO-TPU on PyTorch and CUDA: the port of ``eco_tpu`` to an NVIDIA H100.

The JAX package ``eco_tpu`` stays the reference.  This package runs the same
graphs (the GraphSpec IR and model builders are imported from ``eco_tpu``,
which hold no framework code) with PyTorch ops, and replaces each Pallas
kernel with a kernel written by hand for Hopper.

- ``eco_tpu_torch.ops``      -- channels-last op library (conv, Caffe pools,
                                BN math, elementwise, fc, softmax) and the
                                uint8 crop/normalize kernel (``csrc/``).
- ``eco_tpu_torch.runtime``  -- GraphSpec -> inference ``Program``.
- ``eco_tpu_torch.convert``  -- weight bridge from ``eco_tpu`` params,
                                sibling-1x1 merge and BN folding.
- ``eco_tpu_torch.apps``     -- ``UInt8Server``: uint8 frames in, class
                                probabilities out.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
