"""On the card: each cell's driver at the smoke sizes runs through the
CUDA kernels and comes out correct, and each control fails there too.
Skips without a card (decided inside the fixture). On the GPU machine:

    python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
import pytest
import torch

from bench.drivers import lm, ngp
from smoke import limits, lm_config, lm_traffic, ngp_config, ngp_traffic


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,traffic", [
    ("ngp-fresh-800", "orbit-fresh-800"),
    ("ngp-revisit-800", "hotset-zipf-800")])
def test_ngp_cell_on_the_card(card, workload, traffic):
    out = ngp.run(ngp_config(), ngp_traffic(traffic), limits(workload),
                  2**31 + 31, 1.0, True, card, control=True)
    assert out.correct, {k: (c.value, c.limit) for k, c in out.checks.items()}
    lim = limits(workload)
    assert (out.counters["control_rgb_max_abs"] > lim["rgb_max_abs"]
            or out.counters["control_rgb_mean_abs"] > lim["rgb_mean_abs"])
    assert out.trace.busy_s > 0 and out.work["ngp_field_s"] > 0


@pytest.mark.cuda
def test_lm_cell_on_the_card(card):
    cfg = lm_config()
    cfg["torch_dtype"] = "bfloat16"
    out = lm.run(cfg, lm_traffic(), limits("llava-vqa-offline"), 2**31 + 32,
                 1.0, True, card, control=True)
    assert out.correct, {k: (c.value, c.limit) for k, c in out.checks.items()}
    assert out.trace.busy_s > 0 and out.work["attention_s"] > 0
