"""A run of the whole-file path on the card at test size, as configured
and with long reads (the chop's wide rows); skips without a CUDA device."""

import pytest

from perfbench.tests.conftest import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["hifi", "long_reads"])
def test_card_run_is_correct(variant):
    import time

    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from perfbench import harness
    from perfbench.tests.conftest import LONG_READS
    cell = small_cell("hifi30x.whole", 2000,
                      **(LONG_READS if variant == "long_reads" else {}))
    out = harness.run_cell(cell, 2**31 + 3, 1.0, True, time.perf_counter(),
                           device="cuda")
    assert out.result["correct"], out.result["checks"]
    assert out.result["device"]["busy_s"] > 0
    assert {"device.idle_pct", "device_step_roofline"} <= set(
        out.result["metrics"])
    assert 0 < out.result["metrics"]["device_step_roofline"]["value"] <= 100
