"""Model zoo: the 8 reference configurations (2 families x 4 datasets),
C3D-ResNet-18 (ECO's 3D head's initialisation), and I3D-RGB, Video Swin-B
and MViTv2-B on Kinetics-400, which only this package has.

Class counts and classifier names match the reference prototxts
(models_ECO_Lite/*/ECO_Lite.prototxt:1858-1881 and models_ECO_Full/*):
kinetics=400/fc8(fc8N), ucf101=101/fc8u, hmdb51=51/fc8h(fc8u),
something_something=174/fc8u(fc8N).
"""

from __future__ import annotations

from functools import partial

from eco_tpu_torch.models.eco import build_eco_full, build_eco_lite

# (num_classes, lite_fc, full_fc, lite_dropout, full_dropout)
DATASETS = {
    "kinetics": (400, "fc8", "fc8N", 0.3, 0.5),
    "ucf101": (101, "fc8u", "fc8u", 0.6, 0.5),
    "hmdb51": (51, "fc8h", "fc8u", 0.6, 0.5),
    "something_something": (174, "fc8u", "fc8N", 0.3, 0.5),
}

REGISTRY = {}
for _ds, (_nc, _lfc, _ffc, _ldr, _fdr) in DATASETS.items():
    REGISTRY[f"eco_lite_{_ds}"] = partial(
        build_eco_lite, num_classes=_nc, fc_name=_lfc, dropout_ratio=_ldr
    )
    REGISTRY[f"eco_full_{_ds}"] = partial(
        build_eco_full, num_classes=_nc, fc_name=_ffc, dropout_ratio=_fdr
    )


from eco_tpu_torch.models.c3d_resnet18 import build_c3d_resnet18

REGISTRY["c3d_resnet18_kinetics"] = partial(build_c3d_resnet18, num_classes=400)
REGISTRY["c3d_resnet18_ucf101"] = partial(build_c3d_resnet18, num_classes=101)

from eco_tpu_torch.models.i3d import build_i3d

REGISTRY["i3d_rgb_kinetics"] = partial(build_i3d, num_classes=400)

from eco_tpu_torch.models.video_swin import build_video_swin

REGISTRY["video_swin_b_kinetics"] = partial(build_video_swin, num_classes=400)

from eco_tpu_torch.models.mvit import build_mvit_v2

REGISTRY["mvit_v2_b_kinetics"] = partial(build_mvit_v2, num_classes=400)


def get_model(name: str, **overrides):
    """Build a zoo model; overrides pass through to the builder
    (num_segments, batch, with_loss, ...)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name](**overrides)
