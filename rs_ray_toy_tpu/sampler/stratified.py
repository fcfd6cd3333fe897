"""Counter-based stratified sampler.

The reference's StratifiedSampler (samplers/stratified.rs) pregenerates
jittered strata per pixel, shuffles them with thread_rng, and hands them out
by dimension counter.  Here it is a pure function

    u(pixel_id, sample_index, dimension) in [0,1)

with the same distribution: sample_index is mapped through a per-
(pixel, dimension) pseudorandom permutation of the strata (replacing the
shuffle — deterministic here), then jittered within its stratum by a hashed
uniform.  Camera film offsets use the 2D xsamp*ysamp grid; every other
dimension is 1D-stratified over spp.  (The reference's fallback to
thread_rng range (-1,1) beyond `dimension` dims — samplers/mod.rs:205-227,
a §2.7 quirk — is replaced by more stratified dims, which only reduces
variance.)
"""

import jax.numpy as jnp

from ..config import DTYPE
from ..core import rng
from ..scene.loader import SamplerSpec


def _permute(i, n, key):
    """Stateless pseudorandom permutation of [0, n).

    Power-of-two n: Kensler CMJ permutation (rng.permute_pow2) — bijective
    per key with uniform fixed-index marginals across keys.  Otherwise:
    keyed cyclic rotation (still a permutation, mildly weaker mixing)."""
    x = i.astype(jnp.uint32)
    key = key.astype(jnp.uint32)
    if n & (n - 1) == 0:
        return rng.permute_pow2(x, n, key)
    rot = key % jnp.uint32(n)
    return ((x + rot) % jnp.uint32(n)).astype(jnp.int32)


class StratifiedSampler:
    def __init__(self, spec: SamplerSpec, seed: int = 0):
        self.xs = spec.xsamp
        self.ys = spec.ysamp
        self.spp = spec.xsamp * spec.ysamp
        self.jitter = spec.jitter
        self.seed = seed

    def _u(self, pixel_id, sample_index, dim, salt):
        d = jnp.asarray(dim, jnp.uint32) * jnp.uint32(64) + jnp.uint32(salt)
        return rng.uniform_float(pixel_id, sample_index, d, self.seed)

    def _stratum(self, pixel_id, sample_index, dim):
        """Permuted stratum index for a given dimension (dim may be a
        scalar or a per-ray array)."""
        dk = jnp.asarray(dim, jnp.uint32) * jnp.uint32(2654435761) + jnp.uint32(
            self.seed
        )
        key = rng.hash_combine(pixel_id.astype(jnp.uint32), dk)
        return _permute(sample_index, self.spp, key)

    def get_1d(self, pixel_id, sample_index, dim):
        s = self._stratum(pixel_id, sample_index, dim)
        j = self._u(pixel_id, sample_index, dim, 0) if self.jitter else 0.5
        return jnp.minimum(
            (s.astype(DTYPE) + j) / self.spp, jnp.float32(1.0 - 1e-7)
        )

    def get_2d(self, pixel_id, sample_index, dim):
        """2D stratified over the xs*ys grid."""
        s = self._stratum(pixel_id, sample_index, dim)
        sx = (s % self.xs).astype(DTYPE)
        sy = (s // self.xs).astype(DTYPE)
        if self.jitter:
            jx = self._u(pixel_id, sample_index, dim, 1)
            jy = self._u(pixel_id, sample_index, dim, 2)
        else:
            jx = jy = 0.5
        u0 = jnp.minimum((sx + jx) / self.xs, jnp.float32(1.0 - 1e-7))
        u1 = jnp.minimum((sy + jy) / self.ys, jnp.float32(1.0 - 1e-7))
        return jnp.stack([u0, u1], axis=-1)
