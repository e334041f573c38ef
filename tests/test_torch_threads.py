"""What the port shares between host threads stays exact under them: the
launch counters (`kernels/_launch.count_launch`), the one build of the
kernel library, and the simulator's cache-statistics memo. Thread workers
of the cell orchestrator and the population split launch kernels and
simulate from several threads at once; `chip_smoke.py` compares the
counters. Each test runs more threads than the host has cores, with the
interpreter's switch interval shortened, and asserts what a lost update
would break."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import gather_composite as gc

N_THREADS = max(8, 2 * (os.cpu_count() or 1))


@pytest.fixture
def short_switches():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(target, n=N_THREADS):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_launch_counter_exact_under_threads(monkeypatch, short_switches):
    """Every thread calls the gather-composite wrapper (its launch stubbed
    out: no card here) 300 times; the counter holds every call."""
    monkeypatch.setattr(gc, "require", lambda *a: None)
    monkeypatch.setattr(gc, "launch", lambda *a: None)
    monkeypatch.setattr(gc.gather_composite_cuda, "launches", 0)
    S, R = 4, 2
    args = (torch.zeros(3), torch.zeros(3, 3), torch.zeros(R * S, dtype=torch.int32),
            torch.ones(R * S, dtype=torch.bool), torch.ones(S), True)
    calls = 300

    def work(_):
        for _ in range(calls):
            gc.gather_composite_cuda(*args)

    _run_threads(work)
    assert gc.gather_composite_cuda.launches == N_THREADS * calls


def test_library_built_once_under_concurrent_first_calls(monkeypatch,
                                                         tmp_path,
                                                         short_switches):
    """Threads that launch their first kernels at once wait for ONE build
    and share its library."""
    builds = []
    gate = threading.Barrier(N_THREADS)

    def fake_build():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)  # a build takes a while
        return build.BuildResult(tmp_path / "lib.so", 0.0, "")

    class FakeLib:
        def __init__(self, path):
            for name in build.SIGNATURES:
                setattr(self, name, type("Entry", (), {})())

    monkeypatch.setattr(build, "_LIBRARY", None)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    got = [None] * N_THREADS

    def work(i):
        gate.wait(timeout=60)
        got[i] = build.library()

    _run_threads(work)
    assert len(builds) == 1
    assert all(lib is got[0] for lib in got) and got[0] is not None
    entry = getattr(got[0], "repro_gather_composite")
    assert entry.restype is build.ctypes.c_int
    assert entry.argtypes == build.SIGNATURES["repro_gather_composite"]


def test_simulator_memo_exact_under_threads(short_switches):
    """Threads share one simulator whose memo holds 3 entries (so it
    clears itself over and over): every thread's metrics equal the same
    policies simulated alone."""
    from repro_torch import hwsim as th
    from repro_torch.nerf import hash_encoding as the
    from repro_torch.nerf import ngp as tngp
    from repro_torch.nerf import render as tr

    cfg = tngp.NGPConfig(
        hash=the.HashEncodingConfig(n_levels=4, log2_table_size=9,
                                    base_resolution=4, max_resolution=32),
        hidden_dim=16, color_hidden_dim=16, geo_feat_dim=7, sh_degree=2)
    rng = np.random.RandomState(0)
    ro = rng.randn(16, 3).astype(np.float32) * 0.1
    rd = rng.randn(16, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    trace = th.build_trace(cfg, tr.RenderConfig(n_samples=4), ro, rd,
                           device="cpu")
    hw = th.HWConfig(coarse_levels=2)
    K, n_mlp = 6, 5
    batches = [tuple(r.randint(1, 9, size=(K, w)).astype(np.float32)
                     for w in (4, n_mlp, n_mlp))
               for r in (np.random.RandomState(s) for s in range(N_THREADS))]
    alone = [th.BatchedNeuRexSimulator(trace, hw, device="cpu")
             .simulate_batch(*b) for b in batches]
    shared = th.BatchedNeuRexSimulator(trace, hw, stats_memo_size=3,
                                       device="cpu")
    got = [None] * N_THREADS

    def work(i):
        for _ in range(5):
            got[i] = shared.simulate_batch(*batches[i])

    _run_threads(work)
    for g, w in zip(got, alone):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
