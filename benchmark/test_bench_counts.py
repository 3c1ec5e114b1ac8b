"""Operation and byte counts against hand-worked values."""

import numpy as np
import pytest

from benchmark import catalog, costs

DEFAULT = catalog.load_cell("default.grid").problem
SPARSE = catalog.load_cell("sparse4096.grid").problem


@pytest.mark.parametrize("p, flops", [
    # 3,136,000 timesteps x 1024 px x 554 + 24,500 x 1024 x 6 + 24,500 x 2 x 4 x 8 x 32^3
    (DEFAULT, 1_779_040_256_000 + 150_528_000 + 51_380_224_000),
    # 898,560 timesteps x 1024 px x 554 + 7,020 x 1024 x 6 + 7,020 x 2 x 4 x 8 x 32^3
    (SPARSE, 509_749_493_760 + 43_130_880 + 14_722_007_040),
], ids=["default", "sparse-4096"])
def test_kernel_operations(p, flops):
    assert costs.gridder_work(p).flops == flops == costs.degridder_work(p).flops


def test_default_bounds():
    g = costs.gridder_work(DEFAULT)
    assert g.flops == 1_830_571_008_000
    # visibilities 1,605,632,000 + uvw 37,632,000 + aterms 32,768,000 + sph 4,096
    # + k 64 + metadata 784,000, pieces 802,816,000
    assert g.bytes == 1_605_632_000 + 37_632_000 + 32_768_000 + 4_096 + 64 + 784_000 \
        + 802_816_000
    assert g.bound_seconds() == pytest.approx(1.8509e-3, rel=1e-4)   # FLOP-bound
    a = costs.grid_add_work(DEFAULT)
    assert (a.flops, a.bytes) == (0, 802_816_000 + 33_554_432)
    assert a.bound_seconds() == pytest.approx(0.24966e-3, rel=1e-4)
    assert costs.degridder_work(DEFAULT).bytes == g.bytes


def test_window_union_hand_worked():
    # two 4x4 windows on an 8x8 grid overlapping in 2x2: 28 pixels, also
    # when the second wraps past both edges
    assert costs.window_union_pixels([0, 2], [0, 2], 8, 4) == 28
    assert costs.window_union_pixels([0, 6], [0, 6], 8, 4) == 28
    assert costs.window_union_pixels([0, 4, 0, 4], [0, 0, 4, 4], 8, 4) == 64
    w = costs.grid_extract_work(DEFAULT, 1000)
    assert w.bytes == 1000 * 4 * 8 + 802_816_000 and w.flops == 0


def test_window_union_against_a_loop():
    rng = np.random.default_rng(5)
    g, n = 64, 8
    cx, cy = rng.integers(0, g, 30), rng.integers(0, g, 30)
    mask = np.zeros((g, g), bool)
    for x, y in zip(cx, cy):
        for i in range(n):
            for j in range(n):
                mask[(y + i) % g, (x + j) % g] = True
    assert costs.window_union_pixels(cx, cy, g, n) == mask.sum()


def test_shares():
    w = costs.Work(flops=int(989e9), bytes=0)          # 1 ms at the peak rate
    assert costs.roofline_pct(w, 2e-3) == pytest.approx(50.0)
    assert costs.flops_pct_of_peak(w.flops, 4e-3) == pytest.approx(25.0)
    b = costs.Work(flops=0, bytes=int(3.35e9))          # 1 ms at the peak bandwidth
    assert costs.roofline_pct(b, 1e-3) == pytest.approx(100.0)
