"""ECO-TPU on PyTorch and CUDA: the port of ``eco_tpu`` to an NVIDIA H100.

The JAX package ``eco_tpu`` stays the reference.  This package runs the same
graphs with PyTorch ops, and replaces each Pallas kernel with a kernel
written by hand for Hopper.  It never imports ``eco_tpu``: the modules it
needs that hold no framework code (the GraphSpec IR, prototxt import, the
model builders, shape arithmetic) are kept here as copies, and graphs cross
between the packages as ``graph_to_json`` text.

- ``eco_tpu_torch.spec``     -- the GraphSpec IR, ``NetBuilder``, prototxt
                                import, and the sibling-1x1 merge.
- ``eco_tpu_torch.models``   -- the model zoo (ECO-Lite, ECO-Full, C3D ...).
- ``eco_tpu_torch.utils``    -- Caffe's conv and pool shape arithmetic.

- ``eco_tpu_torch.ops``      -- channels-last op library (conv, Caffe pools,
                                BN math inference and train, elementwise,
                                dropout, stochastic pool and sum, fc,
                                softmax, loss and accuracy, the multi-scale
                                crop and resize) and
                                the CUDA kernels (``csrc/``): uint8
                                crop/normalize, the fused 3x3/s2 max pool
                                and the int8 convolution (``ops/quant.py``).
- ``eco_tpu_torch.runtime``  -- GraphSpec -> ``Program``, TEST or TRAIN, on
                                the card unless ``device=`` says otherwise;
                                rematerialization; the per-layer profiler.
- ``eco_tpu_torch.convert``  -- weight bridge to and from ``eco_tpu``'s
                                layout, caffemodel import and export,
                                sibling-1x1 merge, BN folding and int8
                                post-training quantization.
- ``eco_tpu_torch.apps``     -- ``UInt8Server``: uint8 frames in, class
                                probabilities out, float or int8 graphs;
                                ``RawPreprocessProgram``:
                                the uint8 plane in front of any Program;
                                online recognition, one stream or many;
                                10-crop evaluation.
- ``eco_tpu_torch.data``     -- the host data planes (copies: video lists,
                                sampling, decoding, ``VideoPipeline``, the
                                Caffe databases, window and segmentation
                                sources) and ``prefetch_to_device``.
- ``eco_tpu_torch.train``    -- Caffe-exact solver step, lr policies,
                                checkpoints in the reference's files, and
                                the ``Trainer``.
- ``eco_tpu_torch.tools``    -- the ``eco`` CLI (``python -m
                                eco_tpu_torch.tools.cli``), the remat memory
                                report, dataset, log and graph tools.

The package imports ``torch`` and never ``jax`` or ``eco_tpu``.
"""

__version__ = "0.1.0"
