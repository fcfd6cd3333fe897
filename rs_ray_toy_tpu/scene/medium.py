"""Participating media, batched (medium/).

Mediums live in a small device table; each ray carries a medium id (-1 =
vacuum).  Homogeneous media use the closed-form Beer-Lambert transmittance
and channel-stratified distance sampling (medium/homogeneous.rs:34-85);
grid media use ratio tracking for tr and delta tracking for sampling
(medium/grid.rs:119-207) as bounded `lax.while_loop`s over the whole ray
batch, with a per-ray hashed RNG chain replacing the reference's stateful
sampler draws inside the loop.

Grid parity note: the reference's `density()` treats its argument as a
[0,1]^3 *medium-space* point scaled by (nx,ny,nz) (grid.rs density());
replicated here with trilinear interpolation over the voxel lattice.
"""

from typing import List

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..config import DTYPE, INV_4_PI, PI
from ..core import vec
from ..core import rng as rngmod
from ..core.transform import apply_point_jnp, apply_vector_jnp
from .loader import MediumSpec

MEDIUM_NONE = -1
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1

_MAX_TRACK_STEPS = 256  # bounded delta/ratio-tracking trips


def pack_mediums(specs: List[MediumSpec], n_channels=3):
    """Device medium table; grid densities padded to a common shape.

    n_channels=60 lifts the sigma spectra via the Smits reflectance basis
    (Spectrum::from_rgb(..., SpectrumType::Reflectance) in
    get_medium_scattering_properties, renderprocess.rs:1126-1131)."""
    m = len(specs)
    C = n_channels
    kind = np.zeros(max(m, 1), np.int32)
    sigma_a = np.zeros((max(m, 1), C), np.float32)
    sigma_s = np.zeros((max(m, 1), C), np.float32)
    g = np.zeros(max(m, 1), np.float32)
    w2m = np.tile(np.eye(4, dtype=np.float32), (max(m, 1), 1, 1))
    inv_max_density = np.ones(max(m, 1), np.float32)
    dims = np.ones((max(m, 1), 3), np.int32)
    grids = []
    max_shape = (1, 1, 1)
    for i, s in enumerate(specs):
        kind[i] = MEDIUM_GRID if s.kind == "grid" else MEDIUM_HOMOGENEOUS
        if C == 3:
            sigma_a[i] = s.sigma_a
            sigma_s[i] = s.sigma_s
        else:
            from ..core import spectral as _sp

            sigma_a[i] = np.asarray(
                _sp.from_rgb(jnp.asarray(s.sigma_a, jnp.float32), _sp.REFLECTANCE)
            )
            sigma_s[i] = np.asarray(
                _sp.from_rgb(jnp.asarray(s.sigma_s, jnp.float32), _sp.REFLECTANCE)
            )
        g[i] = s.g
        if s.kind == "grid":
            w2m[i] = s.world_to_medium
            d = np.asarray(s.density, np.float32)
            grids.append(d)
            dims[i] = (s.nz, s.ny, s.nx)
            inv_max_density[i] = 1.0 / max(float(d.max()), 1e-20)
            max_shape = tuple(
                max(a, b) for a, b in zip(max_shape, d.shape)
            )
        else:
            grids.append(np.zeros((1, 1, 1), np.float32))
    density = np.zeros((max(m, 1),) + max_shape, np.float32)
    for i, d in enumerate(grids):
        density[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d
    return {
        "kind": jnp.asarray(kind),
        "sigma_a": jnp.asarray(sigma_a),
        "sigma_s": jnp.asarray(sigma_s),
        "sigma_t": jnp.asarray(sigma_a + sigma_s),
        "g": jnp.asarray(g),
        "w2m": jnp.asarray(w2m),
        "inv_max_density": jnp.asarray(inv_max_density),
        "dims": jnp.asarray(dims),
        "density": jnp.asarray(density),
        "n": m,
        "C": C,
    }


# ---- Henyey-Greenstein phase function (medium/mod.rs:12-57) ----


def phase_hg(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / jnp.maximum(denom * jnp.sqrt(jnp.maximum(denom, 1e-12)), 1e-12)


def hg_sample(wo, g, u):
    """Sample wi from HG around wo; returns (wi, p).  Mirrors
    HenyeyGreenstein::sample_p including its phi = 2*pi*u[0] quirk (the
    reference reuses u[0] for phi)."""
    small_g = jnp.abs(g) < 1e-3
    sq_den = 1.0 + g - 2.0 * g * u[..., 0]
    sq = (1.0 - g * g) / jnp.where(jnp.abs(sq_den) < 1e-9, 1e-9, sq_den)
    g2_den = jnp.where(jnp.abs(g) < 1e-9, 1e-9, 2.0 * g)
    cos_theta = jnp.where(
        small_g,
        1.0 - 2.0 * u[..., 0],
        -(1.0 + g * g - sq * sq) / g2_den,
    )
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * PI * u[..., 0]  # reference quirk: u[0], not u[1]
    v1, v2 = vec.coordinate_system(wo)
    wi = (
        v1 * (sin_theta * jnp.cos(phi))[..., None]
        + v2 * (sin_theta * jnp.sin(phi))[..., None]
        + wo * cos_theta[..., None]
    )
    return wi, phase_hg(cos_theta, g)


# ---- per-ray RNG chain for tracking loops ----


def _next_u(state):
    state = rngmod.hash_u32(state ^ jnp.uint32(0x9E3779B9))
    return state, rngmod.uniform_float_from_u32(state)


def _next_u_masked(state, mask):
    """_next_u advancing only the lanes in `mask` (grid.rs draws its
    tracking rng per-ray, sequentially: a lane that exited the loop must
    NOT keep consuming draws — otherwise the chain depends on how long
    OTHER lanes in the batch keep looping, i.e. on batch composition)."""
    ns = rngmod.hash_u32(state ^ jnp.uint32(0x9E3779B9))
    return jnp.where(mask, ns, state), rngmod.uniform_float_from_u32(ns)


def _grid_density(mediums, med_id, p_medium):
    """Trilinear density lookup in medium space [0,1]^3 (grid.rs:80-117)."""
    dims = mediums["dims"][med_id]  # (N,3) as (nz,ny,nx)
    nz = dims[..., 0].astype(DTYPE)
    ny = dims[..., 1].astype(DTYPE)
    nx = dims[..., 2].astype(DTYPE)
    ps = jnp.stack(
        [
            p_medium[..., 0] * nx - 0.5,
            p_medium[..., 1] * ny - 0.5,
            p_medium[..., 2] * nz - 0.5,
        ],
        axis=-1,
    )
    pf = jnp.floor(ps)
    d = ps - pf
    pi = pf.astype(jnp.int32)

    def texel(ox, oy, oz):
        x = pi[..., 0] + ox
        y = pi[..., 1] + oy
        z = pi[..., 2] + oz
        inside = (
            (x >= 0)
            & (x < dims[..., 2])
            & (y >= 0)
            & (y < dims[..., 1])
            & (z >= 0)
            & (z < dims[..., 0])
        )
        xc = jnp.clip(x, 0, mediums["density"].shape[3] - 1)
        yc = jnp.clip(y, 0, mediums["density"].shape[2] - 1)
        zc = jnp.clip(z, 0, mediums["density"].shape[1] - 1)
        v = mediums["density"][med_id, zc, yc, xc]
        return jnp.where(inside, v, 0.0)

    d00 = texel(0, 0, 0) * (1 - d[..., 0]) + texel(1, 0, 0) * d[..., 0]
    d10 = texel(0, 1, 0) * (1 - d[..., 0]) + texel(1, 1, 0) * d[..., 0]
    d01 = texel(0, 0, 1) * (1 - d[..., 0]) + texel(1, 0, 1) * d[..., 0]
    d11 = texel(0, 1, 1) * (1 - d[..., 0]) + texel(1, 1, 1) * d[..., 0]
    d0 = d00 * (1 - d[..., 1]) + d10 * d[..., 1]
    d1 = d01 * (1 - d[..., 1]) + d11 * d[..., 1]
    return d0 * (1 - d[..., 2]) + d1 * d[..., 2]


def _unit_box_interval(o, d, seg_len):
    """Ray vs [0,1]^3 overlap (grid.rs tr/sample preamble); d unit-length,
    parametric range [0, seg_len]."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    t0 = (0.0 - o) * inv
    t1 = (1.0 - o) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    tmin = jnp.maximum(tn, 0.0)
    tmax = jnp.minimum(tf, seg_len)
    ok = tmin <= tmax
    return ok, tmin, tmax


def medium_tr(mediums, med_id, o, d_unit, seg_len, rng_state):
    """Beam transmittance over [0, seg_len] (Medium::tr).

    Returns (tr (N,3), new_rng_state).  med_id -1 -> 1.
    """
    active_any = mediums["n"] > 0
    if not active_any:
        return jnp.ones((o.shape[0], mediums.get("C", 3)), DTYPE), rng_state
    mid = jnp.maximum(med_id, 0)
    sigma_t = mediums["sigma_t"][mid]
    kind = mediums["kind"][mid]

    # homogeneous closed form (homogeneous.rs:34-36)
    tr_h = jnp.exp(-sigma_t * seg_len[..., None])

    # grid ratio tracking (grid.rs:119-160)
    w2m = mediums["w2m"][mid]
    om = apply_point_jnp(w2m, o)
    dm_raw = apply_vector_jnp(w2m, d_unit)
    scale = vec.length(dm_raw)
    dm = dm_raw / jnp.maximum(scale, 1e-20)[..., None]
    len_m = seg_len * scale
    okb, tmin, tmax = _unit_box_interval(om, dm, len_m)
    st_scalar = sigma_t[..., 0]
    inv_max = mediums["inv_max_density"][mid]

    is_grid = (kind == MEDIUM_GRID) & (med_id >= 0) & okb

    def cond(c):
        t, tr, state, alive = c
        return jnp.any(alive)

    def body(c):
        t, tr, state, alive = c
        state, u1 = _next_u_masked(state, alive)
        t = jnp.where(
            alive,
            t - jnp.log(jnp.maximum(1.0 - u1, 1e-12)) * inv_max / jnp.maximum(st_scalar, 1e-20),
            t,
        )
        past = t >= tmax
        p = om + dm * t[..., None]
        dens = _grid_density(mediums, mid, p)
        tr = jnp.where(
            alive & ~past, tr * (1.0 - jnp.maximum(dens * inv_max, 0.0)), tr
        )
        # RR termination (grid.rs:147-156): the rng draw happens ONLY on
        # the tr < 0.1 branch in the reference — draw-count parity
        low = tr < 0.1
        rr = alive & ~past & low
        state, u2 = _next_u_masked(state, rr)
        q = jnp.maximum(1.0 - tr, 0.05)
        killed = rr & (u2 < q)
        tr = jnp.where(killed, 0.0, jnp.where(rr, tr / (1.0 - q), tr))
        alive = alive & ~past & ~killed
        return t, tr, state, alive

    t0 = jnp.where(is_grid, tmin, jnp.inf)
    tr_g, state = lax.while_loop(
        cond, body, (t0, jnp.ones_like(seg_len), rng_state, is_grid)
    )[1:3]

    tr = jnp.where(
        (kind == MEDIUM_GRID)[..., None], tr_g[..., None], tr_h
    )
    tr = jnp.where((med_id >= 0)[..., None], tr, 1.0)
    return tr, state


def medium_sample(mediums, med_id, o, d_unit, seg_len, rng_state):
    """Medium::sample over [0, seg_len]: possibly samples a scattering
    vertex.  Returns (beta (N,3), sampled (N,), t (N,), new_state)."""
    n = o.shape[0]
    C = mediums.get("C", 3)
    if mediums["n"] == 0:
        return jnp.ones((n, C), DTYPE), jnp.zeros((n,), bool), seg_len, rng_state
    mid = jnp.maximum(med_id, 0)
    kind = mediums["kind"][mid]
    sigma_t = mediums["sigma_t"][mid]
    sigma_s = mediums["sigma_s"][mid]

    # ---- homogeneous (homogeneous.rs:38-85) ----
    # grid lanes draw ONLY their tracking rng (grid.rs:162-207) — the
    # channel/distance draws below belong to the homogeneous estimator
    grid_lane = mediums["kind"][mid] == MEDIUM_GRID
    rng_state, u_ch = _next_u_masked(rng_state, ~grid_lane)
    rng_state, u_d = _next_u_masked(rng_state, ~grid_lane)
    # channel-stratified distance sampling over ALL spectrum channels
    # (homogeneous.rs:45: channel = u * SPECTRUM_N)
    channel = jnp.minimum((u_ch * C).astype(jnp.int32), C - 1)
    st_ch = jnp.take_along_axis(sigma_t, channel[..., None], axis=-1)[..., 0]
    dist = -jnp.log(jnp.maximum(1.0 - u_d, 1e-12)) / jnp.maximum(st_ch, 1e-20)
    t_h = jnp.minimum(dist, seg_len)
    sampled_h = dist < seg_len
    tr_h = jnp.exp(-sigma_t * t_h[..., None])
    density = jnp.where(sampled_h[..., None], sigma_t * tr_h, tr_h)
    pdf = jnp.mean(density, axis=-1)
    pdf = jnp.where(pdf == 0.0, 1.0, pdf)
    beta_h = jnp.where(
        sampled_h[..., None],
        tr_h * sigma_s / pdf[..., None],
        tr_h / pdf[..., None],
    )

    # ---- grid delta tracking (grid.rs:162-207) ----
    w2m = mediums["w2m"][mid]
    om = apply_point_jnp(w2m, o)
    dm_raw = apply_vector_jnp(w2m, d_unit)
    scale = vec.length(dm_raw)
    dm = dm_raw / jnp.maximum(scale, 1e-20)[..., None]
    len_m = seg_len * scale
    okb, tmin, tmax = _unit_box_interval(om, dm, len_m)
    st_scalar = sigma_t[..., 0]
    inv_max = mediums["inv_max_density"][mid]
    is_grid = (kind == MEDIUM_GRID) & (med_id >= 0) & okb

    def cond(c):
        t, hit, state, alive = c
        return jnp.any(alive)

    def body(c):
        t, hit, state, alive = c
        state, u1 = _next_u_masked(state, alive)
        t_new = t - jnp.log(jnp.maximum(1.0 - u1, 1e-12)) * inv_max / jnp.maximum(
            st_scalar, 1e-20
        )
        past = t_new >= tmax
        p = om + dm * t_new[..., None]
        dens = _grid_density(mediums, mid, p)
        # acceptance draw only while inside the segment (grid.rs:169-176
        # breaks on t >= t_max BEFORE the density draw)
        state, u2 = _next_u_masked(state, alive & ~past)
        interact = alive & ~past & (dens * inv_max > u2)
        hit = hit | interact
        t = jnp.where(alive, t_new, t)
        alive = alive & ~past & ~interact
        return t, hit, state, alive

    t_g, hit_g, rng_state, _ = lax.while_loop(
        cond,
        body,
        (
            jnp.where(is_grid, tmin, jnp.inf),
            jnp.zeros((n,), bool),
            rng_state,
            is_grid,
        ),
    )
    beta_g = jnp.where(
        hit_g[..., None],
        sigma_s / jnp.maximum(sigma_t, 1e-20),
        jnp.ones((n, C), DTYPE),
    )

    grid_mask = kind == MEDIUM_GRID
    beta = jnp.where(grid_mask[..., None], beta_g, beta_h)
    sampled = jnp.where(grid_mask, hit_g, sampled_h)
    # world-space parametric t (grid t is in medium units; convert back)
    t_out = jnp.where(grid_mask, t_g / jnp.maximum(scale, 1e-20), t_h)
    in_medium = med_id >= 0
    beta = jnp.where(in_medium[..., None], beta, 1.0)
    sampled = sampled & in_medium
    return beta, sampled, jnp.where(sampled, t_out, seg_len), rng_state
