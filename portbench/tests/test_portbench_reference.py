"""The plain reference against the port's CPU path at a small size, float32.

The reference is the benchmark's yardstick, so it is held here to the
program it judges, where both compute in float32 and must agree to
rounding: serving through ``UInt8Server`` on the folded and merged graph.
"""

import copy
import math

import pytest
import torch

from portbench import check, harness, load, spec
from portbench.reference import eco

SMALL = dict(crop_size=64, num_segments=4, frame_height=72, frame_width=90,
             precision="float32")


def small_cell(name, **traffic):
    """A cell of BENCHMARK.json at a small size."""
    cell = spec.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(SMALL)
    cell.traffic = {**cell.traffic, "pool": 2, **traffic}
    return cell


def test_reference_modules_import_nothing_of_the_program():
    import portbench.reference as ref
    from pathlib import Path

    for path in Path(ref.__file__).parent.glob("*.py"):
        text = path.read_text()
        assert "eco_tpu" not in text and "import jax" not in text, path


@pytest.mark.parametrize("variant,fc", [("lite", "fc8"), ("full", "fc8N")])
def test_shapes_of_the_params_match_the_port(variant, fc):
    from eco_tpu_torch.models.zoo import get_model
    from eco_tpu_torch.runtime.executor import Program

    graph = get_model(f"eco_{variant}_kinetics", batch=1, num_segments=4, crop_size=224)
    params, state = Program(graph, device="cpu").init(
        torch.Generator().manual_seed(0), {"data": graph.inputs["data"]})
    mine, stats = eco.param_specs(eco.layers(variant, 400, fc, 0.5, 4),
                                  {"num_segments": 4, "crop_size": 224})
    assert {(s.layer, s.name): s.shape for s in mine} == {
        (ln, pn): tuple(t.shape) for ln, d in params.items() for pn, t in d.items()}
    assert {(s.layer, s.name): s.shape for s in stats} == {
        (ln, pn): tuple(t.shape) for ln, d in state.items() for pn, t in d.items()}


# the draws of ECO's weights as the benchmark made them before each
# configuration's reference gave its own: a Laplace scale for every weight,
# a uniform range by name for the rest
_PARENT_RANGES = {"b": (-0.1, 0.1), "gamma": (0.8, 1.2), "beta": (-0.2, 0.2),
                  "mean": (-0.2, 0.2), "var": (0.8, 1.25)}


def _parent_draw(s, reads_clips):
    if s.name == "w":
        fan_in = math.prod(s.shape[1:])
        return 0.0, 0.0, math.sqrt(1.0 / fan_in) / (75.0 if s.layer in reads_clips else 1.0)
    return _PARENT_RANGES[s.name] + (0.0,)


@pytest.mark.parametrize("name", ["lite_batch32", "full_batch32"])
def test_eco_draws_are_the_earlier_ones(name):
    """ECO's specs give each weight the draw it had, in the same order, so
    that a seed gives the same weights as before, bit for bit."""
    cell = spec.cell(name)
    net = cell.reference.net(cell.config)
    params, stats = cell.reference.param_specs(net, cell.config)
    reads_clips = {l.name for l in net if l.bottoms[0] == "data"}
    assert reads_clips == {"conv1_7x7_s2"} and params[0].layer == "conv1_7x7_s2"
    for s in params + stats:
        assert (s.low, s.high, s.laplace) == _parent_draw(s, reads_clips), s


def _float32_agree(numbers, lines):
    assert numbers["prob_kl_worst"] < 1e-9, lines
    assert numbers["logit_rel_err_worst"] < 1e-5, lines


def test_serving_lite_matches_the_port_in_float32():
    numbers = {}
    _, lines = harness.run("lite_batch32", 2**31 + 7, 0.5, False, device="cpu",
                           cell=small_cell("lite_batch32", videos=2), numbers=numbers)
    _float32_agree(numbers, lines)


def test_serving_full_matches_the_port_in_float32():
    cell = small_cell("full_batch32", videos=1, pool=1, sample_requests=1)
    cell.config.update(crop_size=224, num_segments=2, frame_height=232, frame_width=240)
    numbers = {}
    _, lines = harness.run("full_batch32", 5, 0.2, False, device="cpu", cell=cell,
                           numbers=numbers)
    _float32_agree(numbers, lines)


def test_serving_numbers_ignore_the_softmax_constant():
    z = torch.randn(3, 400, dtype=torch.float64)
    assert check.logit_rel_err(torch.softmax(z, -1), z + 5.0).max() < 1e-12
    assert check.logit_rel_err(torch.softmax(z.roll(1, -1), -1), z).min() > 1.0
    assert check.prob_kl(torch.softmax(z, -1) * 0.9, z + 5.0).abs().max() < 1e-12
    assert check.prob_kl(torch.softmax(z.roll(1, -1), -1), z).min() > 0.1


def test_frames_are_smooth_fields_from_the_seed():
    """The same seed gives the same frames; neighbouring pixels agree far
    more than in uniform noise; every video has its own brightness."""
    spec_ = spec.cell("lite_batch32").traffic["frames"]
    shape = (3, 2, 72, 90, 3)
    a = load.frame_pool(1, shape, 2**33 + 5, "cpu", spec_)[0]
    b = load.frame_pool(1, shape, 2**33 + 5, "cpu", spec_)[0]
    c = load.frame_pool(1, shape, 2**33 + 6, "cpu", spec_)[0]
    assert a.dtype == torch.uint8 and torch.equal(a, b) and not torch.equal(a, c)
    f = a.double()
    step = (f[:, :, :, 1:] - f[:, :, :, :-1]).abs().mean()
    assert step < 0.25 * (f - f.mean()).abs().mean()
    means = f.mean(dim=(1, 2, 3, 4))
    assert means.max() - means.min() > 5
