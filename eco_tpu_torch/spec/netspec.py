"""Pythonic graph builder -- the TPU-native ``net_spec.py``.

The reference offers ``caffe/net_spec.py`` for building NetParameter graphs
in Python; this is the same idea over our IR.  Methods return the top blob
name so graphs read like the dataflow:

    b = NetBuilder("eco_lite")
    x = b.input("data", (N, S, 224, 224, 3))
    x = b.layer("fold", "fold_segments", x)
    x = b.conv_bn_relu("conv1_7x7_s2", x, 64, k=7, s=2, p=3)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec, ParamSpec


class NetBuilder:
    def __init__(self, name: str):
        self._graph = GraphSpec(name)

    # -- generic -----------------------------------------------------------

    def input(self, name: str, shape: Sequence[int]) -> str:
        self._graph.inputs[name] = tuple(shape)
        return name

    def layer(
        self,
        name: str,
        type: str,
        bottoms: str | Sequence[str] = (),
        *,
        tops: Optional[str | Sequence[str]] = None,
        phase: Optional[str] = None,
        params: Sequence[ParamSpec] = (),
        **options: Any,
    ) -> str | tuple[str, ...]:
        if isinstance(bottoms, str):
            bottoms = (bottoms,)
        if tops is None:
            tops = (name,)
        elif isinstance(tops, str):
            tops = (tops,)
        self._graph.layers.append(
            LayerSpec(
                name=name,
                type=type,
                bottoms=tuple(bottoms),
                tops=tuple(tops),
                options=dict(options),
                phase=phase,
                params=tuple(params),
            )
        )
        return tops[0] if len(tops) == 1 else tuple(tops)

    # -- common layers -------------------------------------------------------

    def conv(self, name, bottom, num_output, *, k, s=1, p=0, bias=True, group=1,
             weight_filler=None, lr=(1.0, 1.0), decay=(1.0, 2.0)):
        """Default lr/decay multipliers follow the reference 2D trunk convs
        (weight lr1/decay1, bias lr1/decay2, ECO_Lite.prototxt:186-193);
        pass lr=(1,2), decay=(1,0) for the 3D-head/FC style."""
        params = (ParamSpec(lr[0], decay[0]),)
        if bias:
            params = params + (ParamSpec(lr[1], decay[1]),)
        return self.layer(
            name, "convolution", bottom,
            num_output=num_output, kernel_size=k, stride=s, pad=p,
            bias_term=bias, group=group,
            weight_filler=weight_filler or {"type": "xavier"},
            bias_filler={"type": "constant", "value": 0.0},
            params=params,
        )

    def bn(self, name, bottom, *, frozen=False, lr=1.0):
        return self.layer(
            name, "bn", bottom, frozen=frozen,
            params=(ParamSpec(0.0 if frozen else lr, 0.0),) * 2,
        )

    def relu(self, name, bottom):
        # In-place like the reference prototxts (top == bottom).
        return self.layer(name, "relu", bottom, tops=bottom)

    def conv_bn_relu(self, name, bottom, num_output, *, k, s=1, p=0,
                     frozen_bn=False, bias=True):
        """The reference's Conv+BN+ReLU triple with its naming convention."""
        c = self.conv(name, bottom, num_output, k=k, s=s, p=p, bias=bias)
        b = self.bn(name + "_bn", c, frozen=frozen_bn)
        return self.relu(name + "_relu", b)

    def max_pool(self, name, bottom, *, k, s=1, p=0):
        return self.layer(name, "pooling", bottom, pool="max",
                          kernel_size=k, stride=s, pad=p)

    def avg_pool(self, name, bottom, *, k, s=1, p=0):
        return self.layer(name, "pooling", bottom, pool="ave",
                          kernel_size=k, stride=s, pad=p)

    def concat(self, name, bottoms):
        return self.layer(name, "concat", bottoms)

    def eltwise_sum(self, name, bottoms):
        return self.layer(name, "eltwise", bottoms, operation="sum")

    def dropout(self, name, bottom, ratio):
        return self.layer(name, "dropout", bottom, tops=bottom,
                          dropout_ratio=ratio)

    def fc(self, name, bottom, num_output):
        return self.layer(
            name, "innerproduct", bottom, num_output=num_output,
            weight_filler={"type": "xavier"},
            bias_filler={"type": "constant", "value": 0.0},
            params=(ParamSpec(1.0, 1.0), ParamSpec(2.0, 0.0)),
        )

    def build(self) -> GraphSpec:
        self._graph.validate()
        return self._graph
