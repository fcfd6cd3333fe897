"""Counter-based uniform generator.

The reference's samplers fall back to stateful `thread_rng()`
(samplers/mod.rs:205-227), which is nondeterministic across runs.  Here every
uniform is a pure function of (pixel_id, sample_index, dimension, seed) via a
PCG-style integer hash — bit-stable across runs and devices, and cheap
(a handful of integer ops, no threefry rounds).
"""

import jax.numpy as jnp

_U32 = jnp.uint32


def hash_u32(x):
    """lowbias32 finalizer-style avalanche hash on uint32."""
    x = x.astype(_U32)
    x ^= x >> 16
    x *= _U32(0x7FEB352D)
    x ^= x >> 15
    x *= _U32(0x846CA68B)
    x ^= x >> 16
    return x


def hash_combine(a, b):
    """Combine two u32 streams (boost-style mix, then avalanche)."""
    a = a.astype(_U32)
    b = b.astype(_U32)
    return hash_u32(a ^ (b + _U32(0x9E3779B9) + (a << 6) + (a >> 2)))


def permute_pow2(i, n, key):
    """Kensler's CMJ permutation of [0, n) for power-of-two n (Andrew
    Kensler, "Correlated Multi-Jittered Sampling", 2013 — single pass when
    n is a power of two).

    Two properties matter here: (1) bijective on [0, n) for every key, so
    a pixel that consumes all n sample indices covers every stratum
    exactly once; (2) near-uniform per-index marginals across keys — each
    round mixes a DIFFERENT key bit-field, so for a fixed sample index the
    stratum is equidistributed over pixels.  The previous construction
    xor'd the same low key bits every round, which made fixed-index
    marginals up to 3x off uniform (several strata unreachable) — biasing
    any consumer that doesn't exhaust all n indices per pixel."""
    w = jnp.uint32(n - 1)
    i = jnp.asarray(i).astype(_U32)
    p = jnp.asarray(key).astype(_U32)
    i ^= p
    i *= _U32(0xE170893D)
    i ^= p >> 16
    i ^= (i & w) >> 4
    i ^= p >> 8
    i *= _U32(0x0929EB3F)
    i ^= p >> 23
    i ^= (i & w) >> 1
    i *= _U32(1) | (p >> 27)
    i *= _U32(0x6935FA69)
    i ^= (i & w) >> 11
    i *= _U32(0x74DCCA23)
    i ^= p >> 2
    i *= _U32(0x9E501CC3)
    i ^= (i & w) >> 2
    i *= _U32(0xC860A3DF)
    i &= w
    i ^= i >> 5
    return ((i + p) & w).astype(jnp.int32)


def uniform_u32(pixel_id, sample_index, dim, seed=0):
    """One u32 per (pixel, sample, dim, seed)."""
    h = hash_combine(
        jnp.asarray(pixel_id), jnp.asarray(sample_index).astype(_U32)
    )
    h = hash_combine(h, jnp.asarray(dim).astype(_U32))
    h = hash_combine(h, jnp.asarray(seed).astype(_U32))
    return h


def uniform_float(pixel_id, sample_index, dim, seed=0):
    """Uniform in [0, 1) with 24-bit resolution (exact in f32).

    The u32 is cast through int32 (exact: value < 2^24) — Mosaic has no
    direct uint32 -> float32 lowering, and the detour is free under XLA."""
    u = uniform_u32(pixel_id, sample_index, dim, seed)
    return (u >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(2.0**-24)


def uniform_float_from_u32(u):
    return (u.astype(_U32) >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        2.0**-24
    )
