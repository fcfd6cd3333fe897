"""chip_smoke.py's comparison helpers, on CPU arrays, and its refusal to
run without a GPU."""

import numpy as np
import pytest

import chip_smoke as cs


def test_image_diff_and_exact_tolerance():
    want = np.full((10, 10, 3), 0.5)  # 100 lit pixels
    got = want.copy()
    got[0, 0, 1] += 5e-3  # one pixel of 100 over 1e-3
    stats = cs.image_diff(got, want, cs.EXACT_TOL)
    assert stats["max"] == pytest.approx(5e-3)
    assert stats["share_over"] == pytest.approx(0.01)
    assert stats["golden_lit"] == stats["lit"] == 100
    assert cs.golden_ok(stats, "exact")
    got[0, 1, 0] += 5e-3  # two pixels: 2% over
    assert not cs.golden_ok(cs.image_diff(got, want, cs.EXACT_TOL), "exact")
    with pytest.raises(ValueError):
        cs.image_diff(np.zeros((4, 4, 3)), want, cs.EXACT_TOL)


def test_shares_count_lit_pixels_only():
    # 20 lit pixels on a 40x24 film: one wrong lit pixel is 5% of the lit
    # ones (0.1% of the film) and fails the 1% bound
    want = np.zeros((24, 40, 3))
    want[10, :20] = 0.3
    got = want.copy()
    got[10, 0, 0] += 0.1
    stats = cs.image_diff(got, want, cs.EXACT_TOL)
    assert stats["golden_lit"] == 20
    assert stats["share_over"] == pytest.approx(0.05)
    assert not cs.golden_ok(stats, "exact")
    # a pixel lit only in the render counts as lit, and as wrong
    got = want.copy()
    got[0, 39] = 0.2
    stats = cs.image_diff(got, want, cs.EXACT_TOL)
    assert stats["lit"] == 21 and stats["share_over"] == pytest.approx(1 / 21)


def test_black_golden_checks_nothing_and_fails():
    want = np.full((24, 40, 3), 1e-30)  # a medium too dense to see through
    for kind in ("exact", "stochastic"):
        stats = cs.image_diff(want, want, cs.EXACT_TOL)
        assert stats["golden_lit"] == 0
        assert not cs.golden_ok(stats, kind)


def test_stochastic_tolerance_needs_mean_and_share():
    want = np.full((10, 10, 3), 0.5)
    got = want.copy()
    got[:3, 0, 0] += 0.05  # 3% of pixels over 1e-2, small mean
    stats = cs.image_diff(got, want, cs.STOCH_TOL)
    assert cs.golden_ok(stats, "stochastic")
    got[3, 0, 0] += 0.05  # 4% over
    assert not cs.golden_ok(cs.image_diff(got, want, cs.STOCH_TOL), "stochastic")
    # every pixel slightly off: share passes, the mean does not
    stats = cs.image_diff(want + 5e-3, want, cs.STOCH_TOL)
    assert stats["share_over"] == 0.0
    assert not cs.golden_ok(stats, "stochastic")


def test_hits_agree_accepts_ties_and_rejects_wrong_hits():
    t = np.array([1.0, 2.0, 3.0, np.inf])
    idx = np.array([0, 1, 2, -1])
    hit = np.array([True, True, True, False])
    stats, ok = cs.hits_agree(t, idx, hit, t, idx, hit)
    assert ok and stats["both_hit"] == 3
    # another primitive at the same t is a tie (shared edge)
    stats, ok = cs.hits_agree(t, np.array([0, 5, 2, -1]), hit, t, idx, hit)
    assert ok
    # another primitive at another t is a wrong hit
    t2 = t.copy()
    t2[1] = 2.5
    stats, ok = cs.hits_agree(t2, np.array([0, 5, 2, -1]), hit, t, idx, hit)
    assert not ok and stats["t_over_tol"] == 1
    # one hit/miss flip in four rays is far above 1e-4
    stats, ok = cs.hits_agree(t, idx, ~hit, t, idx, hit)
    assert not ok and stats["hit_mismatch_share"] == 1.0


def test_films_agree_relative_tolerance():
    a = np.full((4, 4, 3), 10.0, np.float32)
    a[1, 1] = 1e-3  # a dim pixel is held to its own scale
    info, ok = cs.films_agree(a, a.copy())
    assert ok and info["bit_equal"] and info["max_ulp"] == 0
    b = a.copy()
    b[0, 0, 0] += 5e-5  # relative 5e-6
    info, ok = cs.films_agree(a, b)
    assert ok and not info["bit_equal"] and info["values_differing"] == 1
    assert info["max_ulp"] == 52  # 5e-5 in float32 steps of 2**-20 near 10
    b[0, 0, 0] += 1e-3
    assert not cs.films_agree(a, b)[1]
    # 1e-6 on a pixel of 1e-3 is relative 1e-3: far too much, although
    # it is 2e-8 of the film's largest value
    b = a.copy()
    b[1, 1, 0] += 1e-6
    info, ok = cs.films_agree(a, b)
    assert not ok and info["max_abs_diff"] == pytest.approx(1e-6, rel=1e-2)
    # near zero the floor holds: 1e-8 on a black pixel passes
    c = np.zeros((2, 2, 3), np.float32)
    d = c.copy()
    d[0, 0, 0] = 1e-8
    assert cs.films_agree(c, d)[1]


def test_device_phase_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.phase_device()
