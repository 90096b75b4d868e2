"""The FLOP and byte counts against numbers worked out by hand."""

import pytest

from benchmark import roofline as rf

BSB = [101, 256, 256, 256, 256, 1]
HESTON = [3, 256, 256, 256, 256, 1]


def test_forward_macs():
    assert rf.macs(BSB) == 101 * 256 + 3 * 256**2 + 256 == 222_720
    assert rf.macs(HESTON) == 3 * 256 + 3 * 256**2 + 256 == 197_632


def test_training_iteration():
    # 12 F FLOPs at M (N + 1) evaluations: 13.6 GFLOP for the flagship
    assert rf.train_flops(BSB, 100, 50) == 12 * 222_720 * 100 * 51
    assert rf.train_flops(BSB, 100, 50) == pytest.approx(13.63e9, rel=1e-3)
    assert rf.train_flops(HESTON, 500, 50) == pytest.approx(6.048e10, rel=1e-3)


def test_kernel_bounds():
    # K1 and K2 at B = 100 are bound by their bytes, K3 by its operations
    k1 = rf.bound_s(*rf.k1_work(BSB, 100))
    assert k1 == pytest.approx((4 * 100 * 203 + 4 * 223_745) / 3.35e12)
    assert k1 * 1e3 == pytest.approx(0.00029, abs=1e-5)
    k2 = rf.bound_s(*rf.k2_work(BSB, 100))
    assert k2 * 1e3 == pytest.approx(0.00057, abs=1e-5)
    flops, _ = rf.k2_work(BSB, 100)
    assert flops == 2 * 100 * (222_464 * 5 + 3 * 65_536 + 512)
    k3 = rf.bound_s(*rf.k3_work(BSB, 16384, 50))
    assert k3 == pytest.approx(2 * 16384 * 51 * 222_720 / 989e12)
    assert k3 * 1e3 == pytest.approx(0.376, abs=1e-3)


def test_rollout_flops():
    assert rf.rollout_flops(BSB, 16384, 50) == 2 * 16384 * 51 * 222_720
