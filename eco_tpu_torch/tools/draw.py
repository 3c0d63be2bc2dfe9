# A copy of eco_tpu/tools/draw.py (no framework code); tests/test_torch_cli.py holds it to the original.
"""Graph visualization -- caffe draw.py equivalent (graphviz dot text)."""

from __future__ import annotations

from eco_tpu_torch.spec.graph import GraphSpec

_COLORS = {
    "convolution": "#cde6ff",
    "bn": "#ffe9c8",
    "pooling": "#d8f5d8",
    "innerproduct": "#f3d1f4",
    "eltwise": "#fff3b0",
    "concat": "#e0e0e0",
}


def to_dot(graph: GraphSpec) -> str:
    lines = [f'digraph "{graph.name}" {{', "  rankdir=TB;",
             '  node [shape=record, fontsize=10];']
    for name in graph.inputs:
        lines.append(f'  "blob_{name}" [shape=oval, label="{name}"];')
    for l in graph.layers:
        color = _COLORS.get(l.type, "#ffffff")
        extra = ""
        if l.type == "convolution":
            k = l.opt("kernel_size")
            extra = f"\\n{l.opt('num_output')}ch k={k} s={l.opt('stride', 1)}"
        label = f"{l.name}\\n({l.type}){extra}"
        lines.append(
            f'  "layer_{l.name}" [label="{label}", style=filled, '
            f'fillcolor="{color}"];'
        )
        for b in l.bottoms:
            lines.append(f'  "blob_{b}" -> "layer_{l.name}";')
        for t in l.tops:
            if t not in l.bottoms:
                lines.append(f'  "blob_{t}" [shape=oval, label="{t}"];')
            lines.append(f'  "layer_{l.name}" -> "blob_{t}";')
    lines.append("}")
    return "\n".join(lines)
