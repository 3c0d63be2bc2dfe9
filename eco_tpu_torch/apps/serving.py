"""Serving path: raw uint8 frames in, class probabilities out.

Twin of ``eco_tpu/apps/serving.py:UInt8Server``, float plane only: the
crop/mirror/mean kernel (``ops/preprocess.py``) followed by an
inference-optimized ``Program``.  The host ships uint8, a quarter of the
bytes of f32 clips, and does no per-frame math.  The int8 plane is not
ported yet: a quantized graph (``qconvolution`` layers) already fails to
build a ``Program``.
"""

from __future__ import annotations

from typing import Optional

import torch

from eco_tpu_torch.ops.preprocess import preprocess_on_device


class UInt8Server:
    """Batched video scorer over raw resized frames.

    frames: uint8 (N, S, H, W, 3) BGR (e.g. 256x340 decoder output), on any
    device; they are moved to the program's device.  Crops are center unless
    offsets are given.

    As in the reference, the kernel always emits **bf16** clips, and the
    program's ``cast_input`` then decides the compute type: with
    ``compute_dtype=None`` the model runs in bf16.

    ``output`` names the blob to return (default ``probs``); unlike the
    reference it may be any blob of the graph, e.g. the logits.
    """

    def __init__(self, program, params, state, *, crop: int = 224,
                 mean=(104.0, 117.0, 123.0), output: Optional[str] = None):
        self.program = program
        self.params = params
        self.state = state
        self.crop = crop
        self.mean = mean
        self.output = output or (
            "probs" if "probs" in program.output_names else program.output_names[-1]
        )

    def __call__(self, frames_u8, *, h_off=None, w_off=None, mirror=None):
        dev = self.program.device
        frames_u8 = torch.as_tensor(frames_u8).to(dev, non_blocking=True)
        n, s, h, w, _ = frames_u8.shape
        if h_off is None:
            h_off = torch.full((n,), (h - self.crop) // 2, dtype=torch.int32, device=dev)
        if w_off is None:
            w_off = torch.full((n,), (w - self.crop) // 2, dtype=torch.int32, device=dev)
        if mirror is None:
            mirror = torch.zeros((n,), dtype=torch.bool, device=dev)
        clips = preprocess_on_device(
            frames_u8, h_off, w_off, mirror, crop=self.crop, mean=self.mean)
        outs, _ = self.program.apply(
            self.params, self.state, {"data": clips}, capture=[self.output])
        return outs[self.output]
