"""Low-discrepancy point machinery (lowdiscrepancy.rs).

Everything is counter-based index math — (dimension, sample_index) -> u —
which is stateless and batches over rays.  Base-2 uses bit reversal
(lowdiscrepancy.rs:169-184); general bases run a fixed-trip digit loop
(lowdiscrepancy.rs:230-238) with the trip count chosen per base so that
b^trips >= 2^32.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _first_primes(n):
    sieve_limit = 10000
    while True:
        sieve = np.ones(sieve_limit, dtype=bool)
        sieve[:2] = False
        for i in range(2, int(sieve_limit**0.5) + 1):
            if sieve[i]:
                sieve[i * i :: i] = False
        primes = np.nonzero(sieve)[0]
        if len(primes) >= n:
            return primes[:n].astype(np.int64)
        sieve_limit *= 2


# PRIME_NUMS table (lowdiscrepancy.rs:8-165) — first 1024 primes, generated
# rather than transcribed.
N_PRIMES = 1024
PRIMES = _first_primes(N_PRIMES)
PRIME_SUMS = np.concatenate([[0], np.cumsum(PRIMES)])[:N_PRIMES]


def reverse_bits_32(x):
    """(lowdiscrepancy.rs:169-177); x: uint32 array."""
    u = jnp.uint32
    x = x.astype(u)
    x = (x << 16) | (x >> 16)
    x = ((x & u(0x00FF00FF)) << 8) | ((x & u(0xFF00FF00)) >> 8)
    x = ((x & u(0x0F0F0F0F)) << 4) | ((x & u(0xF0F0F0F0)) >> 4)
    x = ((x & u(0x33333333)) << 2) | ((x & u(0xCCCCCCCC)) >> 2)
    x = ((x & u(0x55555555)) << 1) | ((x & u(0xAAAAAAAA)) >> 1)
    return x


def _digit_trips(base):
    return int(math.ceil(32.0 / math.log2(base)))


def radical_inverse_base(base, a, dtype=jnp.float32, max_val=None):
    """Radical inverse in a *static* base; a: int array (non-negative).

    Matches radical_inverse (lowdiscrepancy.rs:230-238): digits of a in
    `base` mirrored about the radix point.  Non-binary bases ride the
    same grouped-digit tables as the scrambled form (identity
    permutation, zero tail); max_val bounds the digit count.
    """
    if base == 2:
        rb = reverse_bits_32(a.astype(jnp.uint32))
        # 0x1p-32 scaling; min with 1-eps like the reference.
        return jnp.minimum(
            rb.astype(jnp.float32) * jnp.float32(2.0**-32),
            jnp.float32(1.0 - 1e-7),
        ).astype(dtype)
    ident = jnp.arange(base, dtype=jnp.int32)
    return scrambled_radical_inverse_base(
        base, a, ident, dtype=dtype, max_val=max_val
    )


def radical_inverse(prime_index, a, dtype=jnp.float32):
    """radical_inverse dispatching on a static prime index."""
    return radical_inverse_base(int(PRIMES[prime_index]), a, dtype)


def inverse_radical_inverse(base, inverse, n_digits):
    """(lowdiscrepancy.rs:239-249): reverse `n_digits` digits back."""
    def body(_, carry):
        inv, index = carry
        nxt = inv // base
        digit = inv - nxt * base
        return nxt, index * base + digit

    inv0 = inverse.astype(jnp.int32)
    _, index = lax.fori_loop(0, n_digits, body, (inv0, jnp.zeros_like(inv0)))
    return index


def scrambled_radical_inverse_base(
    base, a, perm, dtype=jnp.float32, max_val=None
):
    """(lowdiscrepancy.rs:272+): digit-permuted radical inverse.

    perm: (base,) int array permuting digits.  Includes the reference's
    correction term perm[0] * base / (base - 1) folded into the tail — the
    standard PBRT formulation sums perm(0) over the infinite tail:
    (inv * base^trips + perm[0]/(base-1)-ish).  We replicate PBRT v3:
        (rev + perm[0] * inv_base_n / (1 - inv_base)) * inv_base_n...
    evaluated with the same finite-trip structure.

    max_val: static exclusive upper bound on `a` when the caller knows it
    (the HaltonSampler's index < spp*stride); cuts the digit count from
    the 2^32 default — base 3 runs 21 trips for 2^32 but only 15 for the
    256-spp bench index bound.

    Implementation: grouped-digit tables.  The per-digit loop (one
    permutation row-select per digit, 10-21 trips) dominated the Halton
    slot payload (tools/profile_halton.py); instead the digit positions
    are split into groups of k = floor(log_base(1024)) digits and a host
    table of base^k entries holds each group's permuted partial sum, so
    the device does ceil(trips/k) one-hot row selections + the integer
    splits.  Tables are f64-accumulated on host, so the grouped f32 sum
    is at least as accurate as the old sequential f32 loop.
    """
    from .tableops import take_rows

    trips = _digit_trips(base)
    if max_val is not None:
        trips = min(trips, int(math.ceil(math.log(max(max_val, 2), base))))
    inv_base = 1.0 / base
    # group size: largest k with base^k <= 1024 (tableops one-hot range)
    k = max(1, int(math.floor(math.log(1024.0, base))))
    try:
        perm_np = np.asarray(perm, np.int64)
    except jax.errors.TracerArrayConversionError:
        # traced perm (a caller computing payloads under jit): the host
        # group tables can't be built — keep the per-digit loop, with
        # the permutation lookup still riding tableops one-hot
        return _scrambled_loop(base, a, perm, trips, inv_base, dtype)
    # infinite tail of perm[0] digits past the finite trip count
    # (PBRT v3 formulation the reference follows)
    tail = float(perm_np[0]) * inv_base / (1.0 - inv_base)

    a32 = a.astype(jnp.int32)
    acc = None
    pos = 0
    while pos < trips:
        g = min(k, trips - pos)  # digits in this group
        m = base**g
        # table[v] = sum_i perm(digit_i(v)) * base^-(pos+i+1), f64 host
        v = np.arange(m, dtype=np.int64)
        part = np.zeros(m, np.float64)
        vv = v.copy()
        for i in range(g):
            part += perm_np[vv % base] * float(base) ** -(pos + i + 1)
            vv //= base
        if pos + g >= trips:
            part += tail * float(base) ** -(pos + g)
        tab = jnp.asarray(part.astype(np.float32))
        grp = a32 % m if pos + g < trips else a32
        term = take_rows(tab, jnp.clip(grp, 0, m - 1))
        acc = term if acc is None else acc + term
        a32 = a32 // m
        pos += g
    if acc is None:
        acc = jnp.full(a32.shape, np.float32(tail), jnp.float32)
    return jnp.minimum(acc, jnp.float32(1.0 - 1e-7)).astype(dtype)


def _scrambled_loop(base, a, perm, trips, inv_base, dtype):
    """Per-digit fallback (the pre-grouped-table form) for traced perms."""
    from .tableops import take_rows

    perm_f = perm.astype(jnp.float32)

    def body(_, carry):
        val, acc, inv = carry
        nxt = val // base
        digit = val - nxt * base
        pd = take_rows(perm_f, digit)
        return nxt, acc + pd * inv * inv_base, inv * inv_base

    a32 = a.astype(jnp.int32)
    _, acc, inv_base_n = lax.fori_loop(
        0,
        trips,
        body,
        (a32, jnp.zeros(a32.shape, jnp.float32),
         jnp.ones(a32.shape, jnp.float32)),
    )
    tail = perm[0].astype(jnp.float32) * inv_base / (1.0 - inv_base)
    val = acc + inv_base_n * tail
    return jnp.minimum(val, jnp.float32(1.0 - 1e-7)).astype(dtype)


def compute_radical_inverse_permutations(seed=0):
    """Host build of per-prime digit permutations
    (lowdiscrepancy.rs:250-270).  Deterministic (seeded) unlike the
    reference's thread_rng — determinism is a feature of this build
    (SURVEY §2.6)."""
    rng = np.random.default_rng(seed)
    total = int(PRIME_SUMS[-1] + PRIMES[-1])
    perms = np.zeros(total, dtype=np.int32)
    offset = 0
    for p in PRIMES:
        perms[offset : offset + p] = rng.permutation(p)
        offset += p
    return perms
