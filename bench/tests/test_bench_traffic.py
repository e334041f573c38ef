"""The traffic generators are seeded and repeatable."""
import numpy as np
import pytest
import torch

from bench.drivers import lm, ngp
from bench.lib import cameras
from smoke import lm_config, lm_traffic, ngp_traffic

CELL = (0.05, 0.05)


def poses(name, seed, n, viewers=3):
    p = ngp.Poses(ngp_traffic(name), seed, *CELL)
    return [p.next(i % viewers) for i in range(n)]


@pytest.mark.parametrize("name", ["orbit-fresh-800", "hotset-zipf-800"])
def test_poses_repeat_by_seed(name):
    a, b = poses(name, 7, 40), poses(name, 7, 40)
    for x, y in zip(a, b):
        assert np.array_equal(x[0], y[0]) and x[1] == y[1]
        assert np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])


def test_seed_orders_the_same_work():
    """Another seed: the viewers' first asks in another order (orbits, each
    viewer on its fixed path) or the deck in another order (hotset)."""
    tr = ngp_traffic("orbit-fresh-800")
    p7, p9 = ngp.Poses(tr, 7, *CELL), ngp.Poses(tr, 2**31 + 5, *CELL)
    assert sorted(p7.first) == sorted(p9.first) and p7.first != p9.first
    for v in range(3):
        assert np.array_equal(p7.next(v)[0], p9.next(v)[0])
    a, c = poses("hotset-zipf-800", 7, 64), poses("hotset-zipf-800", 9, 64)
    key = lambda cards: sorted((x[0].tobytes(), x[1]) for x in cards)
    assert key(a) == key(c)
    assert [x[1] for x in a] != [x[1] for x in c] or \
        [x[0].tobytes() for x in a] != [x[0].tobytes() for x in c]


def test_orbit_cells_never_repeat():
    keys = [cameras.pose_cell_key(ro, rd, *CELL)
            for _, _, ro, rd in poses("orbit-fresh-800", 3, 300)]
    assert len(set(keys)) == len(keys)


def test_hotset_deck_is_zipf_and_half_jittered():
    tr = ngp_traffic("hotset-zipf-800")
    p = ngp.Poses(tr, 11, *CELL)
    n = tr["poses"]["deck"]
    cards = [p.next(0) for _ in range(n)]
    thetas = [float(np.arctan2(c[0][2, 3], c[0][0, 3])) % (2 * np.pi)
              for c in cards]
    counts = np.array([sum(abs(t - th) < 1e-3 for t in thetas)
                       for th in tr["poses"]["thetas"]])
    w = 1.0 / np.arange(1, 9) ** tr["poses"]["zipf_s"]
    assert counts.sum() == n
    assert np.all(np.abs(counts - n * w / w.sum()) < 1.0)
    assert sum(c[1] != 0.0 for c in cards) == n // 2
    for c2w, shift, ro, rd in cards:  # a jittered card keeps its cell
        exact = cameras.frame_rays(c2w, p.dirs)[0]
        assert cameras.pose_cell_key(ro, rd, *CELL) == \
            cameras.pose_cell_key(exact, rd, *CELL)


def test_text_lengths_come_in_whole_blocks():
    tr = lm_traffic()
    order = lm.lengths(tr, 5, 40)
    assert order == lm.lengths(tr, 5, 40)
    assert order != lm.lengths(tr, 6, 40)
    k = len(tr["text_lengths"])
    for i in range(0, 40, k):
        assert sorted(order[i:i + k]) == sorted(tr["text_lengths"])


def test_batch_inputs_repeat_by_seed():
    model = lm.model_config(lm_config())
    cpu = torch.device("cpu")
    a = lm.batch_inputs(model, 2**31 + 9, 3, 4, 8, cpu)
    b = lm.batch_inputs(model, 2**31 + 9, 3, 4, 8, cpu)
    c = lm.batch_inputs(model, 2**31 + 9, 4, 4, 8, cpu)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
