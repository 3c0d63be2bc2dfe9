"""Declarative graph IR -- the replacement for Caffe's NetParameter.

A copy of ``eco_tpu/spec/graph.py`` (framework-free), kept in the port so
that it never imports ``eco_tpu``; ``graph_to_json`` writes the same
``eco_tpu.graphspec.v1`` format, so graphs cross between the packages as
JSON.  The notes below are the reference's.

The reference builds ``Net<Dtype>`` from a protobuf graph
(``src/caffe/net.cpp:39-316``): phase filtering, in-place tops, param
sharing, backward-need inference.  Here the graph is a plain dataclass IR
that compiles (``eco_tpu.runtime.executor``) into a *pure jittable
function* -- graph construction happens once in Python; execution is one
traced XLA program, so there is no per-layer runtime to optimize and the
reference's activation-memory optimizer (net.cpp:1080-1277) is subsumed by
XLA buffer assignment + optional remat policies.

Phase filtering mirrors net.cpp:318-407 (include/exclude by phase).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence

TRAIN = "train"
TEST = "test"


@dataclass(frozen=True)
class ParamSpec:
    """Per-parameter-blob solver hints (LayerParameter.param, caffe.proto).

    ``lr_mult=0`` freezes a blob; ``decay_mult=0`` exempts it from weight
    decay; ``name`` enables cross-layer param sharing (net.cpp param
    ownership)."""

    lr_mult: float = 1.0
    decay_mult: float = 1.0
    name: Optional[str] = None


@dataclass(frozen=True)
class LayerSpec:
    name: str
    type: str
    bottoms: tuple[str, ...] = ()
    tops: tuple[str, ...] = ()
    options: Mapping[str, Any] = field(default_factory=dict)
    phase: Optional[str] = None  # None = both phases
    params: tuple[ParamSpec, ...] = ()

    def opt(self, key, default=None):
        return self.options.get(key, default)

    def replace(self, **kw) -> "LayerSpec":
        return dataclasses.replace(self, **kw)


@dataclass
class GraphSpec:
    """An executable graph: named inputs (logical NCHW-style shapes) + layers.

    ``inputs`` carries the deploy-style declaration (deploy.prototxt
    input/input_dim); data layers may instead appear as layers with no
    bottoms (their tops are fed by the host pipeline).
    """

    name: str
    inputs: dict[str, tuple[int, ...]] = field(default_factory=dict)
    layers: list[LayerSpec] = field(default_factory=list)
    options: dict = field(default_factory=dict)  # net-level (mem_param, ...)

    def filtered(self, phase: str, *, stages: Sequence[str] = (),
                 level: int = 0) -> "GraphSpec":
        """Keep layers whose NetState rules admit (phase, stages, level)
        (Net::FilterNet/StateMeetsRule, net.cpp:318-407).

        Most layers carry only a phase tag; layers imported from prototxts
        with stage/level rules carry them in options['state_rules'].
        """
        stages = set(stages)

        def rule_matches(rule: dict) -> bool:
            ph = rule.get("phase")
            if ph is not None and str(ph).lower() != phase:
                return False
            if "min_level" in rule and level < int(rule["min_level"]):
                return False
            if "max_level" in rule and level > int(rule["max_level"]):
                return False
            need = rule.get("stage", [])
            need = need if isinstance(need, list) else [need]
            if any(s not in stages for s in need):
                return False
            ban = rule.get("not_stage", [])
            ban = ban if isinstance(ban, list) else [ban]
            if any(s in stages for s in ban):
                return False
            return True

        def keep_layer(l: LayerSpec) -> bool:
            rules = l.opt("state_rules")
            if rules:
                inc = rules.get("include")
                if inc:
                    return any(rule_matches(r) for r in inc)
                exc = rules.get("exclude", [])
                return not any(rule_matches(r) for r in exc)
            return l.phase in (None, phase)

        keep = [l for l in self.layers if keep_layer(l)]
        return GraphSpec(self.name, dict(self.inputs), keep, dict(self.options))

    def layer(self, name: str) -> LayerSpec:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def validate(self) -> None:
        """Every bottom must be produced before use (topological file order,
        as Caffe requires); duplicate non-in-place tops are errors."""
        available = set(self.inputs)
        for l in self.layers:
            for b in l.bottoms:
                if b not in available:
                    raise ValueError(
                        f"layer {l.name!r}: bottom {b!r} not yet produced"
                    )
            for t in l.tops:
                available.add(t)


def graph_to_json(graph: GraphSpec) -> str:
    """Serialize a GraphSpec to JSON -- used to persist transformed graphs
    (e.g. the BN-folded inference graph, which has no prototxt source)."""
    import json

    def layer_dict(l: LayerSpec) -> dict:
        d = {
            "name": l.name,
            "type": l.type,
            "bottoms": list(l.bottoms),
            "tops": list(l.tops),
            "options": _jsonable(l.options),
        }
        if l.phase is not None:
            d["phase"] = l.phase
        if l.params:
            d["params"] = [
                {"lr_mult": p.lr_mult, "decay_mult": p.decay_mult,
                 **({"name": p.name} if p.name else {})}
                for p in l.params
            ]
        return d

    return json.dumps(
        {
            "format": "eco_tpu.graphspec.v1",
            "name": graph.name,
            "inputs": {k: list(v) for k, v in graph.inputs.items()},
            "options": _jsonable(graph.options),
            "layers": [layer_dict(l) for l in graph.layers],
        },
        indent=1,
    )


def _jsonable(v):
    if isinstance(v, Mapping):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def graph_from_json(text: str) -> GraphSpec:
    import json

    d = json.loads(text)
    if d.get("format") != "eco_tpu.graphspec.v1":
        raise ValueError(f"not a GraphSpec JSON artifact: {d.get('format')!r}")
    layers = [
        LayerSpec(
            name=l["name"],
            type=l["type"],
            bottoms=tuple(l.get("bottoms", ())),
            tops=tuple(l.get("tops", ())),
            options=l.get("options", {}),
            phase=l.get("phase"),
            params=tuple(ParamSpec(**p) for p in l.get("params", ())),
        )
        for l in d["layers"]
    ]
    return GraphSpec(
        name=d.get("name", ""),
        inputs={k: tuple(v) for k, v in d.get("inputs", {}).items()},
        layers=layers,
        options=d.get("options", {}),
    )
