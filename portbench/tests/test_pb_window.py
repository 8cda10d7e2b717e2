"""The window's rate, its 95th percentile, the seeded sample of answers
and the right-hand sides."""

import numpy as np
import pytest

import pb_helpers  # noqa: F401
from portbench import stats, traffic

MIX = {"rhs_count": 3, "rhs": {"distribution": "uniform", "low": -1.0,
                                "high": 1.0}}


def test_window_ms():
    assert stats.window_ms(30.0, 250) == pytest.approx(120.0)


def test_percentile_nearest_rank():
    values = list(range(1, 201))               # 200 solves
    assert stats.percentile(values, 95) == 190  # ten lie above it
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 95) == 4
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_right_hand_sides_from_the_seed():
    for seed in (0, 7, 2 ** 31 + 11, -3, 2 ** 70):
        a = traffic.right_hand_sides(MIX, 1000, "float32", seed)
        assert a.dtype == np.float32 and a.shape == (3, 1000)
        assert a.min() >= -1.0 and a.max() < 1.0
        np.testing.assert_array_equal(
            a, traffic.right_hand_sides(MIX, 1000, "float32", seed))
    b = traffic.right_hand_sides(MIX, 1000, "float64", 7)
    assert b.dtype == np.float64
    assert not np.array_equal(traffic.right_hand_sides(MIX, 50, "float64", 1),
                              traffic.right_hand_sides(MIX, 50, "float64", 2))


def test_sample_is_seeded_and_keeps_the_longest():
    def draw(seed):
        s = traffic.Sample(4, seed)
        for k in range(100):
            s.offer(k, 50 if k == 63 else k % 7, k)
        return s.items()

    a = draw(5)
    assert a == draw(5)
    assert (63, 63) in a and len(a) in (4, 5)
    assert [k for k, _ in a] == sorted(k for k, _ in a)
    assert any(draw(s) != a for s in (6, 7, 8))
