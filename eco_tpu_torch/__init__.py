"""ECO-TPU on PyTorch and CUDA: the port of ``eco_tpu`` to an NVIDIA H100.

The JAX package ``eco_tpu`` stays the reference.  This package runs the same
graphs (the GraphSpec IR and model builders are imported from ``eco_tpu``,
which hold no framework code) with PyTorch ops, and replaces each Pallas
kernel with a kernel written by hand for Hopper.

- ``eco_tpu_torch.ops``      -- channels-last op library (conv, Caffe pools,
                                BN math inference and train, elementwise,
                                dropout, fc, softmax, loss and accuracy) and
                                the CUDA kernels (``csrc/``): uint8
                                crop/normalize, the fused 3x3/s2 max pool
                                and the int8 convolution (``ops/quant.py``).
- ``eco_tpu_torch.runtime``  -- GraphSpec -> ``Program``, TEST or TRAIN.
- ``eco_tpu_torch.convert``  -- weight bridge to and from ``eco_tpu``'s
                                layout, sibling-1x1 merge, BN folding and
                                int8 post-training quantization.
- ``eco_tpu_torch.apps``     -- ``UInt8Server``: uint8 frames in, class
                                probabilities out, float or int8 graphs;
                                ``RawPreprocessProgram``:
                                the uint8 plane in front of any Program.
- ``eco_tpu_torch.train``    -- Caffe-exact solver step, lr policies,
                                checkpoints in the reference's files, and
                                the ``Trainer``.

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
