"""Halton global sampler as pure index math (samplers/halton.rs).

Already counter-based in the reference, so it maps to batched index
math.  Per-pixel sample offsets come from the CRT construction (halton.rs:75-105): we precompute
the (128 x 128) offset table on host once (the reference recomputes per
pixel change) and gather on device.

Dimensions: 0 -> base-2 radical inverse of index >> exp_x,
1 -> base-3 of index / scale_y, >=2 -> scrambled radical inverse in the
dim-th prime with the global digit permutations
(lowdiscrepancy.rs:250-270; deterministic seed here).

Integrator call sites pass *static* dimension slots; traced (per-ray
branch-salted) dims fall back to the hash RNG — only the Debug/Direct
specular tree uses those, and Halton there has no reference analogue
anyway (Halton is the Path-integrator config).
"""

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE
from ..core import lowdiscrepancy as ld
from ..core import rng
from ..scene.loader import SamplerSpec

K_MAX_RESOLUTION = 128


def _multiplicative_inverse(a, n):
    # extended euclid (halton.rs:131-150)
    def ext_gcd(a, b):
        if b == 0:
            return 1, 1
        d = a // b
        xp, yp = ext_gcd(b, a % b)
        return yp, xp - d * yp

    x, _ = ext_gcd(a, n)
    return x % n


class HaltonSampler:
    def __init__(self, spec: SamplerSpec, xres, yres, seed=0):
        self.spp = spec.nsamp
        self.sample_at_center = spec.sample_at_center
        self.seed = seed

        scales, exps = [], []
        for i, base in enumerate((2, 3)):
            res = min((xres, yres)[i], K_MAX_RESOLUTION)
            scale, exp = 1, 0
            while scale < res:
                scale *= base
                exp += 1
            scales.append(scale)
            exps.append(exp)
        self.base_scales = scales
        self.base_exponents = exps
        self.sample_stride = scales[0] * scales[1]
        inv = [
            _multiplicative_inverse(scales[1], scales[0]),
            _multiplicative_inverse(scales[0], scales[1]),
        ]

        # host-precomputed per-(px%128) / per-(py%128) sample offsets.
        # Stored as two 1-D tables (off = (ox[px] + oy[py]) % stride) so
        # the device lookup is two small-table selections
        ox_m = np.zeros(K_MAX_RESOLUTION, np.int64)
        oy_m = np.zeros(K_MAX_RESOLUTION, np.int64)
        if self.sample_stride > 1:
            px = np.arange(K_MAX_RESOLUTION)
            dim_x = np.array(
                [_inverse_radical_inverse_host(2, int(p), exps[0]) for p in px]
            )
            dim_y = np.array(
                [_inverse_radical_inverse_host(3, int(p), exps[1]) for p in px]
            )
            ox = dim_x * (self.sample_stride // scales[0]) * inv[0]
            oy = dim_y * (self.sample_stride // scales[1]) * inv[1]
            ox_m = ox % self.sample_stride
            oy_m = oy % self.sample_stride
        self.offs_x = jnp.asarray(ox_m, jnp.int32)
        self.offs_y = jnp.asarray(oy_m, jnp.int32)
        self.xres = xres

        # global digit permutations (u16 in the reference; i32 here)
        self.perms = jnp.asarray(ld.compute_radical_inverse_permutations(seed))

        self._fallback = None

    @property
    def pixel_offsets(self):
        """(128,128) [py,px] offset table — derived view of the 1-D
        factors (kept for oracle tests; the device path never builds it)."""
        ox = np.asarray(self.offs_x, np.int64)
        oy = np.asarray(self.offs_y, np.int64)
        return jnp.asarray(
            (ox[None, :] + oy[:, None]) % self.sample_stride, jnp.int32
        )

    def _index(self, pixel_id, sample_index):
        from ..core.tableops import take_rows

        px = (pixel_id % jnp.uint32(self.xres)).astype(jnp.int32) % K_MAX_RESOLUTION
        py = (pixel_id // jnp.uint32(self.xres)).astype(jnp.int32) % K_MAX_RESOLUTION
        off = (
            take_rows(self.offs_x, px) + take_rows(self.offs_y, py)
        ) % jnp.int32(self.sample_stride)
        return off + sample_index.astype(jnp.int32) * self.sample_stride

    def _dim_value(self, pixel_id, sample_index, dim):
        return self._dim_value_idx(self._index(pixel_id, sample_index), dim)

    def _dim_value_idx(self, idx, dim):
        """Halton dim value from a precomputed global sample index."""
        # static index bound: idx = off + s*stride with off < stride and
        # s < spp — cuts the digit-loop trip count (base 3 runs 15 trips
        # at the 256-spp bench bound instead of the 2^32 default's 21)
        bound = max(2, int(self.spp) * int(self.sample_stride))
        if dim == 0:
            if self.sample_at_center:
                return jnp.full(idx.shape, 0.5, DTYPE)
            return ld.radical_inverse_base(2, idx >> self.base_exponents[0])
        if dim == 1:
            if self.sample_at_center:
                return jnp.full(idx.shape, 0.5, DTYPE)
            return ld.radical_inverse_base(
                3, idx // self.base_scales[1],
                max_val=-(-bound // self.base_scales[1]),
            )
        base = int(ld.PRIMES[dim])
        perm = self.perms[int(ld.PRIME_SUMS[dim]) : int(ld.PRIME_SUMS[dim]) + base]
        return ld.scrambled_radical_inverse_base(
            base, idx, perm, max_val=bound
        )

    def _static_dim(self, dim):
        return isinstance(dim, int) and dim < ld.N_PRIMES

    def get_1d(self, pixel_id, sample_index, dim):
        """Slot d consumes Halton dim 2d — the first of the (2d, 2d+1)
        pair the slot owns (sampler/dims.py rule 3) — so a get_1d slot can
        never alias a different get_2d slot's dims."""
        if not self._static_dim(dim):
            return rng.uniform_float(pixel_id, sample_index, dim, self.seed)
        d0 = 2 * dim
        if d0 >= ld.N_PRIMES:
            return rng.uniform_float(pixel_id, sample_index, d0, self.seed)
        return self._dim_value(pixel_id, sample_index, d0)

    def get_2d(self, pixel_id, sample_index, dim):
        """Maps dimension slot d to Halton dims (2d, 2d+1) so that slots 0
        (film) and 1 (lens) line up with the reference's dims 0-3."""
        if not self._static_dim(dim):
            u0 = rng.uniform_float(pixel_id, sample_index, dim, self.seed)
            u1 = rng.uniform_float(
                pixel_id, sample_index, jnp.asarray(dim) + 7919, self.seed
            )
            return jnp.stack([u0, u1], axis=-1)
        d0 = 2 * dim
        d1 = 2 * dim + 1
        if d1 >= ld.N_PRIMES:
            u0 = rng.uniform_float(pixel_id, sample_index, d0, self.seed)
            u1 = rng.uniform_float(pixel_id, sample_index, d1, self.seed)
            return jnp.stack([u0, u1], axis=-1)
        return jnp.stack(
            [
                self._dim_value(pixel_id, sample_index, d0),
                self._dim_value(pixel_id, sample_index, d1),
            ],
            axis=-1,
        )


def _inverse_radical_inverse_host(base, inverse, n_digits):
    index = 0
    for _ in range(n_digits):
        digit = inverse % base
        inverse //= base
        index = index * base + digit
    return index
