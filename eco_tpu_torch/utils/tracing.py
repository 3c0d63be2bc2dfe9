"""Spans and counters at the program's layer boundaries.

- :func:`span` marks a stretch of host work as a ``torch.profiler`` range
  named ``eco.*``.  Spans record exactly when a profiler runs (any
  ``torch.profiler.profile``, or ``runtime/profiler.py:trace``), so they
  land on the profiler's one timeline, beside the device's kernels and
  copies, which the profiler links to the span that launched them.  With no
  profiler running, and while ``torch.export`` or ``torch.compile`` traces,
  a span is one shared no-op context: no profiler op enters an artifact.
  A span is the profiler's C++ range (``_RecordFunctionFast``), not
  ``torch.profiler.record_function``: under a running profiler that costs
  ~2 us a span where ``record_function`` costs ~17 us, which a request of
  several hundred spans would add to the host's enqueue.
- ``COUNTS`` counts work where it happens, whether a profiler runs or not:
  ``serve.requests`` and ``serve.videos`` (``UInt8Server`` calls and the
  videos they scored), ``k1.launches``, ``k2.launches``, ``k3.launches``
  and ``k4.launches`` (launches of the hand-written kernels of
  ``ops/preprocess.py``, ``ops/poolfuse.py``, ``ops/qconv.py`` and
  ``ops/poolk.py``), ``k4.launches.3d`` (those of K4's 3D path),
  ``s2d.launches`` (those of K5, ``ops/s2d.py``), ``k6.launches`` (those of
  K6, the window attention of ``ops/attention.py``), ``k7.launches`` (those
  of K7, the q/k/v pooling of ``ops/pooled_attention.py``),
  ``pool.route`` (float pools on the card that took
  ``ops/pool.py``'s padded route instead of K4), ``pool.bytes`` (the least
  bytes of every ``ops/pool.py:pool_nd`` call: input read once, output
  written once), ``attn.flops`` and ``attn.bytes`` (every window attention
  core of ``ops/attention.py``, K6 or the route: twice the multiply-adds of
  q k^T and of the weights times v, and its least bytes: q, k and v read
  once, the output written once, the route's gathered bias and mask read
  once; host arithmetic on shapes), ``pattn.flops``, ``pattn.bytes`` and
  ``pattn.bias_bytes`` (every pooled attention core of
  ``ops/pooled_attention.py``: twice the multiply-adds of q k^T, of the
  weights times v and of the three relative-position products; its least
  bytes: q, k and v read once, the output written once, the position
  tables read once; and the bytes of position columns the route writes for
  the library's kernel; host arithmetic on shapes), ``qkv_pool.bytes``
  (every q/k/v pooling of ``ops/pooled_attention.py:pool_qkv``, K7 or the
  route: for each of q, k and v, each qkv row some window reads and the
  class token's row read once, each output row written once; host
  arithmetic on shapes).  Take a difference around the stretch of
  interest.

The spans of the program: ``eco.serve`` and ``eco.serve.h2d``
(``apps/serving.py``), ``eco.k1`` (``ops/preprocess.py``), ``eco.apply``
and ``eco.layer.<type>`` (``runtime/executor.py``), ``eco.cast``,
``eco.bias``, ``eco.layout`` and ``eco.pad`` (``ops/conv.py``,
``ops/linear.py``, ``ops/layout.py``), ``eco.s2d`` (``ops/s2d.py``), and
Video Swin's ``eco.window`` (each pad, shift and partition copy and each
reverse, unshift and crop copy of the windowed attention's route; K6 makes
none) and ``eco.attn`` (its attention core: K6's launch or the route's
library call), in ``ops/attention.py``, and MViTv2's ``eco.qkv_pool`` (the
pooling of q, k and v: K7's launch, or the route's layout copy, three
depthwise convs, class token's concats and three norms) and ``eco.pattn`` (the core:
the position columns, the attention, the residual pooling add and the
merge), in ``ops/pooled_attention.py``.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

COUNTS: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` while a profiler runs, else a shared no-op
    context."""
    if torch.compiler.is_compiling() or not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)
