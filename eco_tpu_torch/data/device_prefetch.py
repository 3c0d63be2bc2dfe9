"""Host->device batch prefetch: the copy of batch i+1 overlaps step i.

Twin of ``eco_tpu/data/device_prefetch.py``, the third stage of the feed:

    decode/augment threads (VideoPipeline) -> prefetch_to_device -> step

``size`` is the number of batches in flight ahead of the consumer; the
default of 1 is the reference's (its A/B found deeper queues no faster).

On a card the default put, for each batch:

1. pins every numpy leaf (``pin_memory()``: a host memcpy into a block of
   PyTorch's caching host allocator, in the consumer's thread, inside
   ``next()``, while the card runs the steps enqueued before);
2. copies it with ``non_blocking=True`` on a side ``torch.cuda.Stream`` and
   records an event there.  The caching host allocator keeps the pinned block
   until that copy is done, so no staging buffer is reused too early;
3. when the batch is handed out, the consumer's current stream waits on the
   event, and every device tensor is marked ``record_stream(current)``, so
   the caching allocator does not give its memory to another tensor while the
   consumer's step may still read it.

On the CPU the put is ``.to(device)`` and pins nothing.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def _map_leaves(fn, tree):
    if tree is None:  # an empty subtree, as in a JAX pytree
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf
    # np.require keeps a 0-d leaf 0-d (np.ascontiguousarray makes it 1-d)
    return torch.from_numpy(np.require(np.asarray(leaf), requirements="C"))


class _CardPut:
    """The default put for a card: pinned leaves, copied on a side stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch):
        pinned = _map_leaves(lambda leaf: _as_tensor(leaf).pin_memory(), batch)
        with torch.cuda.stream(self.stream):
            out = _map_leaves(lambda t: t.to(self.device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def hand_over(self, pending):
        out, done = pending
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        _map_leaves(lambda t: t.record_stream(current), out)
        return out


def prefetch_to_device(
    it: Iterable,
    size: int = 1,
    *,
    put_fn: Optional[Callable[[Any], Any]] = None,
    device="cuda",
) -> Iterator:
    """Yield batches from ``it`` already on ``device``, ``size`` ahead.

    ``put_fn`` maps a host batch (a dict, list or tuple tree of numpy arrays
    or tensors) to the batch the consumer gets, and replaces the default put
    (then the caller orders its own copies).  The put of a batch is made when
    it enters the queue; StopIteration from ``it`` drains the queue cleanly.
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    device = torch.device(device)
    if put_fn is not None:
        put, hand_over = put_fn, (lambda pending: pending)
    elif device.type == "cuda":
        card = _CardPut(device)
        put, hand_over = card, card.hand_over
    else:
        put = lambda b: _map_leaves(lambda leaf: _as_tensor(leaf).to(device), b)
        hand_over = lambda pending: pending
    queue: collections.deque = collections.deque()
    src = iter(it)

    def fill():
        while len(queue) < size:
            try:
                batch = next(src)
            except StopIteration:
                return
            queue.append(put(batch))

    fill()
    while queue:
        out = queue.popleft()
        fill()
        yield hand_over(out)
