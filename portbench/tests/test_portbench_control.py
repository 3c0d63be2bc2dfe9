"""The check's control on the card: the program's own int8 path in the bf16
server's place, at the published widths with 8-video requests, has to fail
the cell's check.  The readings at the cells' own sizes, which set the
limits, come from ``python3 -m portbench.control`` (see PERF.md).
"""

import pytest
import torch

from portbench import control, spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lite_batch32", "full_batch32"])
def test_int8_control_fails_the_check(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.benchmark = True
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic, videos=8, pool=2, sample_requests=2)
    seed = 2**31 + 101
    numbers = control.readings(cell, seed, 1.0, "cuda:0",
                               lambda c, p, s, d: control.int8_server(c, p, s, d, seed))
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers
