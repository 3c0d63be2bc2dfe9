"""Raw uint8 frames in: the serving path and the raw train plane.

Twin of ``eco_tpu/apps/serving.py``.  ``UInt8Server`` is the
crop/mirror/mean kernel (``ops/preprocess.py``) followed by an
inference-optimized or int8-quantized ``Program``; ``RawPreprocessProgram``
puts the same kernel in front of any ``Program``, so a train step or a test
pass consumes uint8 batches.  The host ships uint8, a quarter of the bytes
of f32 clips, and does no per-frame math.

Spans and counters (``utils/tracing.py``): an ``UInt8Server`` call is an
``eco.serve`` span, the frames' copy in it an ``eco.serve.h2d`` span; it
counts ``serve.requests`` and ``serve.videos``.
"""

from __future__ import annotations

from typing import Optional

import torch

from eco_tpu_torch.convert.quantize import int8_input_rewrite
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.ops.resize import preprocess_resize_on_device
from eco_tpu_torch.runtime.executor import Program
from eco_tpu_torch.utils.tracing import COUNTS, span


class UInt8Server:
    """Batched video scorer over raw resized frames.

    frames: uint8 (N, S, H, W, 3) BGR (e.g. 256x340 decoder output), on any
    device; they are moved to the program's device.  Crops are center unless
    offsets are given.

    As in the reference, the kernel emits **bf16** clips (int8 on the int8
    input plane below), and the program's ``cast_input`` then decides the
    compute type: with ``compute_dtype=None`` a float model runs in bf16.

    ``output`` names the blob to return (default ``probs``); unlike the
    reference it may be any blob of the graph, e.g. the logits.

    The int8 input plane (``int8_input=True``, the default, as in the
    reference): when every consumer of the input is a quantized layer
    (``convert.quantize.int8_input_rewrite``), the kernel quantizes the
    clips itself at one shared scale and conv1 is fed int8, with no
    separate quantize pass.  A no-op on float graphs.
    """

    def __init__(self, program, params, state, *, crop: int = 224,
                 mean=(104.0, 117.0, 123.0), output: Optional[str] = None,
                 int8_input: bool = True):
        self.in_scale = None
        if int8_input:
            graph, scale = int8_input_rewrite(program.graph)
            if scale is not None:
                program = Program(graph, compute_dtype=program.compute_dtype,
                                  device=program.device)
                self.in_scale = scale
        self.program = program
        self.params = params
        self.state = state
        self.crop = crop
        self.mean = mean
        self.output = output or (
            "probs" if "probs" in program.output_names else program.output_names[-1]
        )

    def clips(self, frames_u8, *, h_off=None, w_off=None, mirror=None):
        """The preprocessing step: frames to the program's device (from pinned
        host memory without a blocking copy), then the kernel.  Default
        offsets are the center crop, made on the host: with host offsets the
        kernel's wrapper needs one small copy and no stream sync."""
        with span("eco.serve.h2d"):
            frames_u8 = torch.as_tensor(frames_u8).to(self.program.device, non_blocking=True)
        n, s, h, w, _ = frames_u8.shape
        if h_off is None:
            h_off = [(h - self.crop) // 2] * n
        if w_off is None:
            w_off = [(w - self.crop) // 2] * n
        if mirror is None:
            mirror = [False] * n
        return preprocess_on_device(
            frames_u8, h_off, w_off, mirror, crop=self.crop, mean=self.mean,
            act_scale=self.in_scale)

    def __call__(self, frames_u8, *, h_off=None, w_off=None, mirror=None):
        COUNTS["serve.requests"] += 1
        COUNTS["serve.videos"] += len(frames_u8)
        with span("eco.serve"):
            clips = self.clips(frames_u8, h_off=h_off, w_off=w_off, mirror=mirror)
            outs, _ = self.program.apply(
                self.params, self.state, {"data": clips}, capture=[self.output])
        return outs[self.output]


class RawPreprocessProgram:
    """Program wrapper for the ``raw`` data plane: batches carry uint8 frames
    and host-sampled augment decisions, and the crop/mirror/mean kernel runs
    on the device in front of the wrapped program.

    Drop-in for ``Program`` in ``make_train_step``/``make_eval_step``/
    ``Trainer``: it delegates graph, outputs and ``total_loss``, and its
    ``apply``/``init`` take ``{"data": uint8 (N, S, H, W, 3), "h_off",
    "w_off", "mirror", "label", ...}``.  Clips come out in the program's
    ``compute_dtype`` (f32 when it is None).  A multi-scale batch (``crop_h``
    and ``crop_w`` in it, sampled per video) takes the crop and bilinear
    resize of ``ops/resize.py`` instead of the kernel.  The clips are made
    before the wrapped program runs, so ``remat`` never recomputes them.
    An image graph, whose ``data`` input is declared (N, H, W, C) (CaffeNet
    and the other Caffe image nets), takes one-frame videos: the kernel's
    (N, 1, crop, crop, 3) clips are viewed as (N, crop, crop, 3) images.
    """

    _AUG_KEYS = ("h_off", "w_off", "mirror", "crop_h", "crop_w")

    def __init__(self, program, *, crop: int = 224, mean=(104.0, 117.0, 123.0)):
        self.inner = program
        self.crop = crop
        self.mean = mean
        # delegated surface used by the solver and the Trainer
        self.graph = program.graph
        self.train = program.train
        self.compute_dtype = program.compute_dtype
        self.device = program.device
        self.output_names = program.output_names
        self.loss_names = program.loss_names
        self.exec_layers = program.exec_layers
        self.total_loss = program.total_loss
        declared = program.graph.inputs.get("data")
        self._images = declared is not None and len(declared) == 4

    def _as_images(self, clips):
        if not self._images:
            return clips
        if clips.shape[1] != 1:
            raise ValueError(f"an image graph takes one frame a video, got {clips.shape[1]}")
        return clips.flatten(0, 1)

    def _clips(self, inputs):
        dtype = self.compute_dtype or torch.float32
        # pinned host frames then reach the device without a blocking copy;
        # the wrapper ships host offsets in one small copy of its own
        frames = torch.as_tensor(inputs["data"]).to(self.device, non_blocking=True)
        if "crop_h" in inputs:
            # multi-scale: the sampled (crop_h, crop_w) window, cropped and
            # resized by two batched products (ops/resize.py)
            return self._as_images(preprocess_resize_on_device(
                frames, inputs["h_off"], inputs["w_off"], inputs["crop_h"], inputs["crop_w"],
                inputs["mirror"], crop=self.crop, mean=self.mean, out_dtype=dtype))
        return self._as_images(preprocess_on_device(
            frames, inputs["h_off"], inputs["w_off"], inputs["mirror"], crop=self.crop,
            mean=self.mean, out_dtype=dtype))

    def _inner_inputs(self, inputs):
        return {k: v for k, v in inputs.items() if k != "data" and k not in self._AUG_KEYS}

    def init(self, generator, sample_inputs):
        inner = self._inner_inputs(sample_inputs)
        n, s = tuple(getattr(sample_inputs["data"], "shape", sample_inputs["data"]))[:2]
        inner["data"] = ((n * s,) if self._images else (n, s)) + (self.crop, self.crop, 3)
        return self.inner.init(generator, inner)

    def apply(self, params, state, inputs, *, generator=None, capture=None, remat=None,
              dist=None):
        inner = self._inner_inputs(inputs)
        inner["data"] = self._clips(inputs)
        return self.inner.apply(params, state, inner, generator=generator, capture=capture,
                                remat=remat, dist=dist)
