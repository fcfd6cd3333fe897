"""Unit tests for the math core against analytic values (SURVEY §4 tier 1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rs_ray_toy_tpu.core import vec, sampling, lowdiscrepancy as ld, spectrum, rng
from rs_ray_toy_tpu.core.math import quadratic, erf_inv, erf
from rs_ray_toy_tpu.core.transform import Transform, apply_point_jnp


def test_vec_basics():
    a = jnp.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    b = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    assert np.allclose(vec.dot(a, b), [0.0, 2.0])
    assert np.allclose(vec.cross(a, b)[0], [0.0, 0.0, 1.0])
    assert np.allclose(vec.length(a), [1.0, 2.0])
    n = vec.normalize(jnp.array([[3.0, 4.0, 0.0]]))
    assert np.allclose(n, [[0.6, 0.8, 0.0]])


def test_coordinate_system_orthonormal():
    v1 = vec.normalize(jnp.array([[1.0, 2.0, 3.0], [0.0, 0.0, 1.0], [-1.0, 0.5, 0.2]]))
    v2, v3 = vec.coordinate_system(v1)
    for a, b in [(v1, v2), (v1, v3), (v2, v3)]:
        assert np.allclose(vec.dot(a, b), 0.0, atol=1e-6)
    assert np.allclose(vec.length(v2), 1.0, atol=1e-6)


def test_reflect_refract():
    wo = vec.normalize(jnp.array([[1.0, 0.0, 1.0]]))
    n = jnp.array([[0.0, 0.0, 1.0]])
    r = vec.reflect(wo, n)
    assert np.allclose(r, vec.normalize(jnp.array([[-1.0, 0.0, 1.0]])), atol=1e-6)
    # normal incidence refraction keeps direction
    wt, ok = vec.refract(jnp.array([[0.0, 0.0, 1.0]]), n, 1.0 / 1.5)
    assert bool(ok[0])
    assert np.allclose(wt, [[0.0, 0.0, -1.0]], atol=1e-6)
    # TIR: grazing from dense medium
    wi = vec.normalize(jnp.array([[0.99, 0.0, 0.05]]))
    _, ok2 = vec.refract(wi, n, 1.5)
    assert not bool(ok2[0])


def test_quadratic():
    ok, t0, t1 = quadratic(jnp.array(1.0), jnp.array(-3.0), jnp.array(2.0))
    assert bool(ok) and np.isclose(t0, 1.0) and np.isclose(t1, 2.0)
    ok, _, _ = quadratic(jnp.array(1.0), jnp.array(0.0), jnp.array(1.0))
    assert not bool(ok)


def test_concentric_disk_in_unit_disk():
    u = jnp.array(np.random.default_rng(0).uniform(size=(1000, 2)))
    d = sampling.concentric_sample_disk(u)
    r2 = d[:, 0] ** 2 + d[:, 1] ** 2
    assert float(jnp.max(r2)) <= 1.0 + 1e-6
    # center maps to center
    assert np.allclose(sampling.concentric_sample_disk(jnp.array([[0.5, 0.5]])), 0.0)


def test_cosine_hemisphere_mean():
    u = jnp.array(np.random.default_rng(1).uniform(size=(20000, 2)))
    w = sampling.cosine_sample_hemisphere(u)
    assert float(jnp.min(w[:, 2])) >= 0.0
    # E[cos theta] for pdf cos/pi is 2/3
    assert abs(float(jnp.mean(w[:, 2])) - 2.0 / 3.0) < 0.01


def test_uniform_sphere():
    u = jnp.array(np.random.default_rng(2).uniform(size=(10000, 2)))
    w = sampling.uniform_sample_sphere(u)
    assert np.allclose(vec.length(w), 1.0, atol=1e-5)
    assert abs(float(jnp.mean(w[:, 2]))) < 0.03


def test_power_heuristic():
    assert np.isclose(float(sampling.power_heuristic(1, 1.0, 1, 1.0)), 0.5)
    assert np.isclose(float(sampling.power_heuristic(1, 2.0, 1, 0.0)), 1.0)


def test_distribution1d_matches_reference_semantics():
    d = sampling.Distribution1D([1.0, 2.0, 1.0])
    # func_int = (1+2+1)/3
    assert np.isclose(d.func_int, 4.0 / 3.0)
    dev = d.as_device()
    idx, pdf = sampling.sample_discrete_1d(dev, jnp.array([0.1, 0.5, 0.95]))
    assert list(np.asarray(idx)) == [0, 1, 2]
    assert np.allclose(pdf, [0.25, 0.5, 0.25])
    x, pdfc, off = sampling.sample_continuous_1d(dev, jnp.array([0.5]))
    assert np.isclose(float(pdfc[0]), 2.0 / (4.0 / 3.0))


def test_distribution2d():
    func = np.array([[1.0, 0.0], [0.0, 3.0]])
    d2 = sampling.Distribution2D(func.ravel(), 2, 2).as_device()
    u = jnp.array(np.random.default_rng(3).uniform(size=(5000, 2)))
    p, pdf = sampling.sample_continuous_2d(d2, u)
    # ~3/4 of samples should land in the v>0.5,u>0.5 cell
    frac = float(jnp.mean((p[:, 0] > 0.5) & (p[:, 1] > 0.5)))
    assert abs(frac - 0.75) < 0.03
    # pdf at a point inside the hot cell: func/int = 3 / 1 = ... func_int marginal
    got = sampling.pdf_2d(d2, jnp.array([[0.75, 0.75]]))
    assert np.isclose(float(got[0]), 3.0 / 1.0, rtol=1e-5)


def test_radical_inverse_base2():
    a = jnp.arange(8)
    got = ld.radical_inverse_base(2, a)
    want = [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]
    assert np.allclose(got, want, atol=1e-6)


def test_radical_inverse_base3():
    a = jnp.arange(9)
    got = ld.radical_inverse_base(3, a)
    want = [0, 1 / 3, 2 / 3, 1 / 9, 4 / 9, 7 / 9, 2 / 9, 5 / 9, 8 / 9]
    assert np.allclose(got, want, atol=1e-5)


def test_radical_inverse_prime_dispatch():
    assert ld.PRIMES[0] == 2 and ld.PRIMES[1] == 3 and ld.PRIMES[2] == 5
    got = ld.radical_inverse(2, jnp.arange(5))
    want = [0, 1 / 5, 2 / 5, 3 / 5, 4 / 5]
    assert np.allclose(got, want, atol=1e-5)


def test_inverse_radical_inverse_roundtrip():
    a = jnp.arange(50)
    # digits of a in base 5, 4 digits
    inv = ld.inverse_radical_inverse(5, a, 4)
    back = ld.inverse_radical_inverse(5, inv, 4)
    assert np.array_equal(np.asarray(back), np.asarray(a))


def test_scrambled_radical_inverse_identity_perm():
    base = 5
    perm = jnp.arange(base)
    a = jnp.arange(20)
    got = ld.scrambled_radical_inverse_base(base, a, perm)
    want = ld.radical_inverse_base(base, a)
    assert np.allclose(got, want, atol=1e-5)


def test_rgb_xyz_roundtrip():
    rgb = jnp.array([[0.2, 0.5, 0.8], [1.0, 1.0, 1.0]])
    back = spectrum.xyz_to_rgb(spectrum.rgb_to_xyz(rgb))
    assert np.allclose(back, rgb, atol=1e-4)
    assert np.isclose(float(spectrum.luminance(jnp.array([1.0, 1.0, 1.0]))), 1.0, atol=1e-4)


def test_gamma_correct_matches_reference():
    # misc.rs:46-52 breakpoints
    assert np.isclose(float(spectrum.gamma_correct(jnp.array(0.001))), 0.01292, atol=1e-5)
    assert np.isclose(
        float(spectrum.gamma_correct(jnp.array(0.5))),
        1.055 * 0.5 ** (1 / 2.4) - 0.055,
        atol=1e-5,
    )


def test_transform_compose_and_apply():
    t = Transform.translate([1.0, 2.0, 3.0]) * Transform.scale(2.0, 2.0, 2.0)
    p = t.apply_point(np.array([1.0, 1.0, 1.0]))
    assert np.allclose(p, [3.0, 4.0, 5.0])
    m = jnp.asarray(t.m, dtype=jnp.float32)
    pj = apply_point_jnp(m, jnp.array([1.0, 1.0, 1.0]))
    assert np.allclose(pj, [3.0, 4.0, 5.0], atol=1e-5)
    inv = t.inverse().apply_point(p)
    assert np.allclose(inv, [1.0, 1.0, 1.0])


def test_transform_rotate():
    t = Transform.rotate(90.0, [0.0, 0.0, 1.0])
    p = t.apply_point(np.array([1.0, 0.0, 0.0]))
    assert np.allclose(p, [0.0, 1.0, 0.0], atol=1e-12)


def test_look_at_matches_reference_convention():
    # camera at origin looking +x: camera-space +z maps to world +x
    t = Transform.look_at([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    c2w = t.m_inv
    d = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
    assert np.allclose(d, [1.0, 0.0, 0.0], atol=1e-12)


def test_erf_inv_roundtrip():
    x = jnp.linspace(-0.9, 0.9, 13)
    r = erf(erf_inv(x))
    assert np.allclose(r, x, atol=2e-3)


def test_rng_deterministic_and_uniform():
    pid = jnp.arange(10000)
    u1 = rng.uniform_float(pid, 3, 7, seed=1)
    u2 = rng.uniform_float(pid, 3, 7, seed=1)
    assert np.array_equal(np.asarray(u1), np.asarray(u2))
    assert 0.0 <= float(jnp.min(u1)) and float(jnp.max(u1)) < 1.0
    assert abs(float(jnp.mean(u1)) - 0.5) < 0.01
    u3 = rng.uniform_float(pid, 3, 8, seed=1)
    assert not np.array_equal(np.asarray(u1), np.asarray(u3))


class TestMipmapEWA:
    def _mip(self, img):
        from rs_ray_toy_tpu.scene.mipmap import build_mipmap

        return build_mipmap(img).as_device()

    def test_constant_image_preserved(self):
        from rs_ray_toy_tpu.scene.mipmap import ewa_lookup

        img = np.full((16, 16, 3), 0.7, np.float32)
        dev = self._mip(img)
        st = jnp.array([[0.3, 0.6], [0.9, 0.1]])
        dst0 = jnp.full((2, 2), 0.05)
        dst1 = jnp.full((2, 2), 0.01)
        out = ewa_lookup(dev, st, dst0, dst1)
        np.testing.assert_allclose(np.asarray(out), 0.7, rtol=1e-4)

    def test_degenerate_falls_back_to_bilerp(self):
        from rs_ray_toy_tpu.scene.mipmap import ewa_lookup, _bilerp_level

        rng = np.random.default_rng(3)
        img = rng.random((8, 8, 3)).astype(np.float32)
        dev = self._mip(img)
        st = jnp.array([[0.25, 0.75]])
        zero = jnp.zeros((1, 2))
        out = ewa_lookup(dev, st, zero, zero)
        ref = _bilerp_level(dev, jnp.zeros((1,), jnp.int32), st)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5)

    def test_anisotropic_blurs_along_major_axis(self):
        from rs_ray_toy_tpu.scene.mipmap import ewa_lookup

        # vertical stripes: wide horizontal footprint must average stripes,
        # narrow vertical footprint on the same point keeps contrast
        img = np.zeros((32, 32, 3), np.float32)
        img[:, ::2] = 1.0
        dev = self._mip(img)
        st = jnp.array([[0.5, 0.5]])
        wide_s = ewa_lookup(
            dev, st, jnp.array([[0.25, 0.0]]), jnp.array([[0.0, 1.0 / 64]])
        )
        narrow = ewa_lookup(
            dev, st, jnp.array([[1.0 / 64, 0.0]]), jnp.array([[0.0, 1.0 / 64]])
        )
        assert abs(float(wide_s[0, 0]) - 0.5) < 0.1  # stripes averaged
        # both finite and within [0,1]
        assert np.all(np.isfinite(np.asarray(narrow)))
        assert 0.0 <= float(narrow[0, 0]) <= 1.0

    def test_eccentricity_clamp_finite(self):
        from rs_ray_toy_tpu.scene.mipmap import ewa_lookup

        rng = np.random.default_rng(5)
        img = rng.random((16, 16, 3)).astype(np.float32)
        dev = self._mip(img)
        st = jnp.array([[0.4, 0.4]])
        # extreme anisotropy: major 100x minor
        out = ewa_lookup(
            dev, st, jnp.array([[0.5, 0.0]]), jnp.array([[0.0, 0.005]])
        )
        assert np.all(np.isfinite(np.asarray(out)))


class TestTableOps:
    def _check(self, table, idx):
        from rs_ray_toy_tpu.core.tableops import take_rows

        got = np.asarray(take_rows(table, idx))
        np.testing.assert_array_equal(got, np.asarray(table)[np.asarray(idx)])

    def test_float_rows_exact(self):
        rng = np.random.default_rng(0)
        table = jnp.asarray(rng.standard_normal((7, 3, 5)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, 7, 1000), jnp.int32)
        self._check(table, idx)

    def test_float_extreme_values_exact(self):
        vals = np.array(
            [1.2e-38, -1e38, np.pi, 1 + 2**-23, 2**24 + 1, -0.0, 7e7, 1e-30],
            np.float32,
        ).reshape(8, 1)
        idx = jnp.asarray(np.arange(8).repeat(13), jnp.int32)
        self._check(jnp.asarray(vals), idx)

    def test_int_rows_exact(self):
        rng = np.random.default_rng(1)
        table = jnp.asarray(rng.integers(-(2**23), 2**23, (36, 12)), jnp.int32)
        idx = jnp.asarray(rng.integers(0, 36, 500), jnp.int32)
        self._check(table, idx)

    def test_bool_rows_exact(self):
        rng = np.random.default_rng(2)
        table = jnp.asarray(rng.integers(0, 2, (5, 4)).astype(bool))
        idx = jnp.asarray(rng.integers(0, 5, 200), jnp.int32)
        self._check(table, idx)

    def test_big_table_onehot(self):
        """Rows of a mesh-sized (19,200-row) table."""
        rng = np.random.default_rng(3)
        table = jnp.asarray(rng.standard_normal((19200, 9)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, 19200, 2048).reshape(64, 32), jnp.int32)
        self._check(table, idx)

    def test_under_jit(self):
        from rs_ray_toy_tpu.core.tableops import take_axis1, take_rows
        import jax

        table = jnp.arange(24, dtype=jnp.float32).reshape(6, 4)
        idx = jnp.asarray([5, 0, 3], jnp.int32)
        got = jax.jit(take_rows)(table, idx)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(table)[np.asarray(idx)]
        )
        v = jnp.arange(3 * 4 * 2, dtype=jnp.float32).reshape(3, 4, 2)
        got = jax.jit(take_axis1)(v, jnp.asarray([3, 0, 2], jnp.int32))
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(v)[np.arange(3), [3, 0, 2]]
        )
