"""Halton sampler unit tests vs hand-computed reference values
(samplers/halton.rs:75-128, lowdiscrepancy.rs:230-238).

The CRT offset construction is checked by its defining invariant: the
index chosen for pixel (px, py) must produce a raw Halton point whose
integer image coordinates equal that pixel.  Dim values are checked
against exact host (f64) radical inverses.
"""

import numpy as np
import jax.numpy as jnp

from rs_ray_toy_tpu.core import lowdiscrepancy as ld
from rs_ray_toy_tpu.sampler.halton import (
    HaltonSampler,
    _multiplicative_inverse,
    _inverse_radical_inverse_host,
)
from rs_ray_toy_tpu.scene.loader import SamplerSpec


def _ri_host(base, a):
    """Exact radical inverse on host (float64)."""
    v, inv, acc = int(a), 1.0 / base, 0.0
    while v:
        acc = acc + (v % base) * inv
        v //= base
        inv /= base
    return acc


def test_multiplicative_inverse_hand_values():
    # halton.rs:131-150 — extended-gcd CRT inverses for a 64x64 film:
    # 81 * 49 = 3969 = 62*64 + 1;  64 * 19 = 1216 = 15*81 + 1
    assert _multiplicative_inverse(81, 64) == 49
    assert _multiplicative_inverse(64, 81) == 19
    # and the general property a * inv(a, n) % n == 1 over coprime pairs
    for a, n in [(3, 128), (128, 243), (243, 128), (5, 7)]:
        assert (a * _multiplicative_inverse(a, n)) % n == 1


def test_scales_exponents_stride():
    # halton.rs:27-44 on a 64x64 film: base-2 scale 64 (exp 6),
    # base-3 scale 81 (exp 4), stride 64*81
    h = HaltonSampler(SamplerSpec(kind="halton", nsamp=4), 64, 64)
    assert h.base_scales == [64, 81]
    assert h.base_exponents == [6, 4]
    assert h.sample_stride == 64 * 81
    # 640x360 film clamps to K_MAX_RESOLUTION=128: scales (128, 243)
    h2 = HaltonSampler(SamplerSpec(kind="halton", nsamp=4), 640, 360)
    assert h2.base_scales == [128, 243]
    assert h2.base_exponents == [7, 5]


def test_inverse_radical_inverse_host_roundtrip():
    # lowdiscrepancy.rs:239-249: irr(base, reversed-digit value, n) recovers
    # the index whose radical inverse has those leading digits
    for base, n_digits in [(2, 6), (3, 4)]:
        for index in range(base**n_digits):
            rev = 0
            v = index
            for _ in range(n_digits):
                rev = rev * base + (v % base)
                v //= base
            assert _inverse_radical_inverse_host(base, rev, n_digits) == index


def test_offset_lands_sample_in_its_pixel():
    """Defining CRT invariant (halton.rs:83-105): for every pixel and
    every sample s, idx = offset(px,py) + s*stride satisfies
    floor(ri2(idx)*scale_x) == px and floor(ri3(idx)*scale_y) == py.

    NOTE the reference itself breaks this for px >= 2^base_exponents[1]:
    halton.rs:92 passes base_exponents[1] (the base-3 exponent) to the
    base-2 inverse, truncating the pixel digits — a transcription bug vs
    PBRT v3's baseExponents[i].  We use the intended exponent
    (docs/PARITY.md)."""
    h = HaltonSampler(SamplerSpec(kind="halton", nsamp=4), 64, 64)
    offs = np.asarray(h.pixel_offsets)
    rng = np.random.default_rng(0)
    for px, py in zip(rng.integers(0, 64, 24), rng.integers(0, 64, 24)):
        for s in (0, 1, 5):
            idx = int(offs[py % 128, px % 128]) + s * h.sample_stride
            assert int(_ri_host(2, idx) * 64) == px
            assert int(_ri_host(3, idx) * 81) == py


def test_dim0_dim1_match_reference_formula():
    """sample_dimension (halton.rs:107-128): dim0 = ri2(idx >> exp_x),
    dim1 = ri3(idx / scale_y) — checked against exact host math."""
    h = HaltonSampler(SamplerSpec(kind="halton", nsamp=8), 64, 64)
    pid = jnp.asarray([0, 1, 63, 64, 2049], jnp.uint32)
    sid = jnp.asarray([0, 1, 2, 3, 4], jnp.uint32)
    got = np.asarray(h.get_2d(pid, sid, 0))
    offs = np.asarray(h.pixel_offsets)
    for row, (p, s) in enumerate(zip(np.asarray(pid), np.asarray(sid))):
        px, py = int(p) % 64, int(p) // 64
        idx = int(offs[py % 128, px % 128]) + int(s) * h.sample_stride
        np.testing.assert_allclose(got[row, 0], _ri_host(2, idx >> 6), atol=2e-7)
        np.testing.assert_allclose(got[row, 1], _ri_host(3, idx // 81), atol=2e-7)


def test_sample_at_center_pins_film_dims_only():
    h = HaltonSampler(
        SamplerSpec(kind="halton", nsamp=4, sample_at_center=True), 64, 64
    )
    pid = jnp.arange(8, dtype=jnp.uint32)
    sid = jnp.zeros(8, jnp.uint32)
    np.testing.assert_array_equal(np.asarray(h.get_2d(pid, sid, 0)), 0.5)
    assert not np.all(np.asarray(h.get_2d(pid, sid, 1)) == 0.5)


def test_scrambled_dims_stratified():
    """Dims >= 2 use scrambled radical inverse in the dim-th prime
    (halton.rs:120-127).  For one pixel, the first `base` consecutive
    samples of slot d (halton dim 2d, prime base b) must occupy b distinct
    strata of width 1/b — the permutation preserves stratification."""
    h = HaltonSampler(SamplerSpec(kind="halton", nsamp=64), 4, 4)
    stride = h.sample_stride  # 4*9 = 36
    assert stride == 36
    for slot, dim in [(2, 4), (3, 6)]:
        base = int(ld.PRIMES[dim])
        pid = jnp.zeros(base, jnp.uint32)
        sid = jnp.arange(base, dtype=jnp.uint32)
        u = np.asarray(h.get_1d(pid, sid, slot))
        assert np.all((u >= 0) & (u < 1))
        # consecutive indices idx = off + s*36; since gcd(36, base)=1 for
        # primes 11/17, the low digit cycles through all residues -> the
        # first `base` samples hit all `base` strata exactly once.
        strata = np.floor(u * base).astype(int)
        assert sorted(strata) == list(range(base))


def test_nonuniform_film_axes():
    # x and y exponents differ (128 vs 243 scales) — offsets stay in range
    h = HaltonSampler(SamplerSpec(kind="halton", nsamp=4), 640, 360)
    offs = np.asarray(h.pixel_offsets)
    assert offs.min() >= 0 and offs.max() < h.sample_stride
    # all 128x128 pixel offsets distinct (CRT bijectivity)
    assert len(np.unique(offs)) == 128 * 128
