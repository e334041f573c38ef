"""On the card: the probe of the program's spans (`bench/spans_probe.py`)
at the smoke sizes. A recorded window carries its cell's metrics of
`bench.lib.spans`; every program span lies inside the benchmark's range
around the same call and encloses its own profiler range (one clock);
the window's idle time closes over the spans and the rest within 1 %;
windows with and without the recording run the same device ops by
name. Skips without a card (decided inside the fixture). On the GPU
machine:

    python -m pytest -q -m cuda bench/tests/test_bench_spans_cuda.py
"""
import pytest
import torch

from bench.lib import spans as sl
from bench.spans_probe import probe
from smoke import lm_config, lm_traffic, ngp_config, ngp_traffic


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ngp", "lm"])
def test_probe_on_the_card(card, kind):
    if kind == "ngp":
        config, traffic = ngp_config(), ngp_traffic("orbit-fresh-800")
    else:
        config = lm_config()
        config["torch_dtype"] = "bfloat16"
        traffic = lm_traffic()
    res = probe(kind, config, traffic, 2**31 + 41, 1.0, 2, card)
    assert res["ops_differ"] == {}
    names = {n for n in sl.READERS if n.startswith(kind + ".")}
    for w in res["windows"]:
        if w["window"] in ("reading", "traced"):
            assert w["busy_s"] > 0 and w["device_ops"] > 0
        if not w["recorded"] or w["window"] in ("plain", "queue"):
            continue
        # A short window may hold no whole queue wait: that reads None.
        assert names - {"ngp.queue_wait_ms"} <= set(w["metrics"]) <= names
        assert all(v == 0 for v in w["unnested"].values()), w["unnested"]
        assert w["clock_margins_us"][0] >= 0, w["clock_margins_us"]
        split = w["idle_split"]
        parts = sum(v for k, v in split.items() if k != "idle")
        assert parts == pytest.approx(split["idle"], rel=1e-9)
        assert split["idle"] == pytest.approx(w["idle_closed_ms"], rel=0.01)
    if kind == "ngp":
        assert res["windows"][-1]["metrics"]["ngp.queue_wait_ms"] > 0
