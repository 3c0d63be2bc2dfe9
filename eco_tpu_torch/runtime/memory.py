"""Activation memory: rematerialization of a train step's forward pass.

Twin of ``eco_tpu/runtime/memory.py``.  The reference Caffe shares
activation buffers between layers (``mem_param { optimize_train: true }``,
net.cpp:980-1277); the JAX reference trades FLOPs for memory instead, by
recomputing activations in the backward pass under a policy:

- ``"nothing"``: keep nothing a region computes; recompute all of it;
- ``"dots"``: keep the convolution and matrix-product outputs
  (``aten.convolution``, ``mm``, ``addmm``, ``bmm``), recompute the
  elementwise work between them (BN's f32 math, ReLU, pools, concats);
- ``"everything"`` (or None): no remat.

Regions.  XLA recomputes the reference's checkpointed function op by op, as
the backward pass needs each value.  ``torch.utils.checkpoint`` (non-
reentrant) instead recomputes a checkpointed region in one go at the first
unpack of one of its saved tensors, so everything the region saved is live
at once: one checkpoint around a whole forward pass would save almost
nothing.  So the executor's layer list is cut into regions that each end
at a Convolution, Deconvolution or InnerProduct layer (a deconvolution is
``aten.convolution`` too), and each region is checkpointed
alone; the backward pass then holds one region's recompute at a time.

What each region keeps for the backward pass:

- its inputs: the blobs it reads that an earlier region or the graph's
  inputs made (for most regions, the previous conv's output, after its
  bias);
- under ``"dots"``, the output of its closing conv or fc, before the bias
  (the product itself), in the selective-checkpoint cache;
- under ``"nothing"``, nothing more.

Parameters are the caller's tensors and stay alive regardless.  Under
either policy a region's closing conv or fc is never run again: its
backward needs its inputs, not its output, and the recompute stops as soon
as the last tensor the region saved is back.  So on these regions "dots"
recomputes what "nothing" does and keeps one product more a region; it is
kept because it is the reference's policy and ``mem_param``'s mapping.

Randomness and state.  The step's seed is drawn once, in ``Program.apply``,
before any region runs, and each layer rebuilds its generator from it
(``Context.layer_generator``), so a recomputed dropout layer draws the same
mask.  ``preserve_rng_state`` is off: no global generator is used.  BN's
running statistics come from the first forward pass only; a recompute
writes its (equal) statistics into a context of its own.  The uint8 crop
kernel of ``RawPreprocessProgram`` runs before ``Program.apply`` and so
outside every region: a recompute never launches it again.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

POLICIES = ("nothing", "dots", "everything")

# layer types that close a region: their outputs are what "dots" keeps
_REGION_ENDS = {"convolution", "deconvolution", "innerproduct"}

_aten = torch.ops.aten
_DOTS = {_aten.convolution.default, _aten._convolution.default, _aten.mm.default,
         _aten.addmm.default, _aten.bmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _check(policy: Optional[str]) -> Optional[str]:
    if policy is not None and policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {POLICIES} or None")
    return None if policy == "everything" else policy


def apply_with_remat(program, policy: Optional[str] = "dots"):
    """``program.apply`` under a remat policy: use it in place of
    ``program.apply`` inside a train step.  ``program`` is a ``Program`` or
    a wrapper that passes ``remat=`` on to one (``RawPreprocessProgram``)."""
    policy = _check(policy)
    if policy is None:
        return program.apply

    def apply(params, state, inputs, *, generator=None, capture=None):
        return program.apply(params, state, inputs, generator=generator, capture=capture,
                             remat=policy)

    return apply


def remat_policy_from_graph(graph) -> Optional[str]:
    """mem_param mapping: optimize_train -> 'dots', absent -> None."""
    mp = getattr(graph, "options", {}).get("mem_param")
    if mp and mp.get("optimize_train"):
        return "dots"
    return None


def regions(layers: Sequence) -> list[list[int]]:
    """Indices of ``layers`` cut after every Convolution / Deconvolution /
    InnerProduct."""
    out, cur = [], []
    for i, layer in enumerate(layers):
        cur.append(i)
        if layer.type.lower() in _REGION_ENDS:
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def run_with_remat(steps: Sequence, blobs: dict, keep: Iterable[str], policy: str,
                   run: Callable[[Sequence, dict, bool], None]) -> None:
    """Run ``steps`` ((layer, impl) pairs) over ``blobs`` in place, each
    region under its own checkpoint.  ``run(part, blobs, first)`` runs some
    steps over a dict of blobs; ``first`` is False when a backward pass
    recomputes them.  ``keep`` names the blobs the caller wants at the end."""
    policy = _check(policy)
    if policy is None:
        run(steps, blobs, True)
        return
    parts = [[steps[i] for i in idx] for idx in regions([layer for layer, _ in steps])]
    later: list[set] = []  # later[r]: blobs read after region r, or kept
    reads = set(keep)
    for part in reversed(parts):
        later.append(set(reads))
        for layer, _ in part:
            reads.update(layer.bottoms)
    later.reverse()
    context_fn = _dots_context if policy == "dots" else noop_context_fn
    for part, wanted in zip(parts, later):
        written: set = set()
        in_names: list = []
        for layer, _ in part:
            in_names += [b for b in layer.bottoms if b not in written and b not in in_names]
            written.update(layer.tops)
        out_names = [t for t in dict.fromkeys(t for layer, _ in part for t in layer.tops)
                     if t in wanted]
        outs = checkpoint(_region(part, in_names, out_names, run),
                          *[blobs[n] for n in in_names], use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
        blobs.update(zip(out_names, outs))


def _region(part, in_names, out_names, run):
    calls = []

    def fn(*xs):
        local = dict(zip(in_names, xs))
        run(part, local, not calls)
        calls.append(None)
        return tuple(local[n] for n in out_names)

    return fn
