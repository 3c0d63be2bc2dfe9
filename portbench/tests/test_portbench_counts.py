"""The FLOP and byte counts against sums worked by hand at small shapes."""

import pytest

from portbench.counts import shapes
from portbench.reference import eco

CFG = {"num_segments": 2, "crop_size": 16}


def test_conv_and_fc_flops_by_hand():
    net = [
        eco.Layer("c1", "conv", ("data",), "c1", {"cout": 8, "k": 3, "s": 2, "p": 1, "dim": 2}),
        eco.Layer("p1", "maxpool", ("c1",), "p1", {"k": 3, "s": 2, "p": 0}),
        eco.Layer("to3d", "to3d", ("p1",), "x3", {"segments": 2}),
        eco.Layer("c3", "conv", ("x3",), "c3", {"cout": 4, "k": 3, "s": 1, "p": 1, "dim": 3}),
        eco.Layer("g", "gap3d", ("c3",), "g", {}),
        eco.Layer("fc", "fc", ("g",), "fc", {"cout": 10}),
    ]
    # c1: 2 frames of 16x16x3 -> 8x8x8, 27 taps; pool -> 4x4 (ceil); c3: depth 2,
    # 4x4 spatial, 8 -> 4 channels, 27 taps; fc 4 -> 10
    c1 = 2 * 8 * 8 * 8 * 3 * 9
    c3 = 2 * 4 * 4 * 4 * 8 * 27
    fc = 4 * 10
    assert shapes.forward_flops(net, CFG) == 2.0 * (c1 + c3 + fc)


def test_k1_bytes_by_hand():
    # 3 videos, 2 segments, 16x16 crops, 3 channels: read as uint8, written as bf16
    assert shapes.k1_bytes(3, CFG, 2) == 3 * 2 * 16 * 16 * 3 * (1 + 2)


@pytest.mark.parametrize("variant,fc,gflop", [("lite", "fc8", 92.972924928),
                                               ("full", "fc8N", 128.825901056)])
def test_published_widths(variant, fc, gflop):
    net = eco.layers(variant, 400, fc, 0.5, 16)
    cfg = {"num_segments": 16, "crop_size": 224}
    assert shapes.forward_flops(net, cfg) / 1e9 == pytest.approx(gflop, rel=1e-12)
    # conv1 alone: 16 frames, 112x112x64 outputs, 7x7x3 taps
    conv1 = 2 * 16 * 112 * 112 * 64 * 147
    assert shapes.forward_flops(net[:1], cfg) == conv1


def test_profile_reduction_by_hand():
    """Busy time is the union of device work; the benchmark's own spans,
    which the profiler also draws on the device's timeline, are not work;
    each idle gap goes to the host operation running at its middle."""
    from types import SimpleNamespace as NS

    import torch

    from portbench import trace

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, start, end, dev):
        return NS(name=name, time_range=NS(start=start, end=end), device_type=dev)

    prof = trace.reduce([
        ev("serve.call", 0, 100, cpu), ev("serve.call", 5, 95, cuda),
        ev("k1", 10, 20, cuda), ev("Memcpy HtoD (Pinned -> Device)", 15, 35, cuda),
        ev("k2", 30, 40, cuda), ev("aten::add", 45, 75, cpu), ev("k3", 80, 90, cuda),
    ], 1.0)
    assert prof.busy_s == pytest.approx(40e-6) and prof.window_s == pytest.approx(100e-6)
    assert prof.htod_s == pytest.approx(20e-6)
    assert prof.kernel_time("k") == pytest.approx((30e-6, 3))
    assert prof.idle_by_host_op == pytest.approx({"serve.call": 20e-6, "aten::add": 40e-6})
    assert [name for name, _ in prof.breakdown()["device_ops"]][0] == "Memcpy HtoD (Pinned -> Device)"
