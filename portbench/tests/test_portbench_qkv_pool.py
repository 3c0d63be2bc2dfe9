"""The reader of ``qkv_pool_roofline.batch`` on hand-made readings: the
pooling's least bytes (``COUNTS["qkv_pool.bytes"]``) at the card's memory
rate over the device time inside ``eco.qkv_pool``, and nothing where a
program lacks the counter or the span (the parent of the change that added
them) or the span launched nothing on a device."""

from types import SimpleNamespace as NS

import pytest

from portbench import spec
from portbench.tests.test_portbench_reference import small_cell

CELL = "mvit_b_batch10"
NAME = "qkv_pool_roofline.batch"


def _readings(counts, spans):
    return NS(counts=counts, spans=spans, traced={"requests": 3},
              peaks={"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12})


def test_entry_and_reader_of_the_cell():
    (entry,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == NAME]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "%", "higher", "program_span", "videos_per_s")
    assert entry["layer"] == "pooled attention: ops/pooled_attention.py pooled_attention"
    assert entry["workloads"] == [CELL]
    reader = small_cell(CELL).readers[NAME]
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (entry["layer"], "%", "videos_per_s")


def test_qkv_pool_roofline_by_hand():
    read = small_cell(CELL).readers[NAME].read
    row = {"calls": 72, "device_ms": 10.0, "self_device_ms": 10.0, "launches": 72}
    # 10.8 GB at 3.35 TB/s is 3.2243 ms of the 10: three requests of
    # 3,600,506,880 B
    r = _readings({"qkv_pool.bytes": 3 * 3_600_506_880}, {"eco.qkv_pool": row})
    assert read(r) == pytest.approx(100 * 3 * 3_600_506_880 / 3.35e12 / 10e-3)
    assert read(r) == pytest.approx(32.243, abs=1e-3)
    # the same bytes in a third of the time
    r = _readings({"qkv_pool.bytes": 3 * 3_600_506_880},
                  {"eco.qkv_pool": dict(row, device_ms=10.0 / 3)})
    assert read(r) == pytest.approx(96.730, abs=1e-3)
    # the core's counters and span are not the pooling's
    r = _readings({"pattn.flops": 1e12, "pattn.bytes": 1e9}, {"eco.pattn": row})
    assert read(r) is None


@pytest.mark.parametrize("counts,spans", [
    ({}, {"eco.qkv_pool": {"device_ms": 10.0}}),                       # no counter: the parent
    ({"qkv_pool.bytes": 1e9}, {}),                                     # no span
    ({"qkv_pool.bytes": 1e9}, {"eco.qkv_pool": {"device_ms": 0.0}}),  # nothing on a device
], ids=["no_counter", "no_span", "no_device_work"])
def test_qkv_pool_roofline_reads_nothing_without_its_sources(counts, spans):
    assert small_cell(CELL).readers[NAME].read(_readings(counts, spans)) is None
