"""Texture system: host registry + batched device evaluation.

The reference's `Texture<T>` trait objects (texture/mod.rs:43) become a flat
registry evaluated data-parallel over hit batches.  Each JSON texture
(renderprocess.rs:298-515) registers a record; referencing textures (mix,
scale, checkerboard) are evaluated in topological order (the JSON builds
bottom-up, so registry order IS topo order — the reference resolves names
against the already-built map the same way).

Device evaluation computes a value for *every* registered texture at every
shading point (registries are tiny), then lobes gather by tex id.  Image
textures use the MIPMap pyramid (mipmap.py); procedural noise matches the
reference's Perlin implementation (texture/mod.rs:75-189).
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE
from ..core import vec
from .mipmap import MIPMap

# texture type codes
TEX_CONSTANT = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_BILERP = 3
TEX_IMAGE = 4
TEX_UV = 5
TEX_CHECKER2D = 6
TEX_CHECKER3D = 7
TEX_WINDY = 8
TEX_WRINKLED = 9

# 2D mapping codes (texture/mod.rs:206-366)
MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3


@dataclass
class TexRecord:
    kind: int
    is_rgb: bool
    value: np.ndarray = field(default_factory=lambda: np.zeros(3))  # constant
    # references into the registry (same float/rgb space as this record,
    # except `amount`/checker args which the loader resolves)
    t1: int = -1
    t1_const: np.ndarray = field(default_factory=lambda: np.ones(3))
    t2: int = -1
    t2_const: np.ndarray = field(default_factory=lambda: np.zeros(3))
    amount: int = -1
    amount_const: float = 0.5
    # bilerp corners
    v00: np.ndarray = field(default_factory=lambda: np.zeros(3))
    v01: np.ndarray = field(default_factory=lambda: np.zeros(3))
    v10: np.ndarray = field(default_factory=lambda: np.zeros(3))
    v11: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # mapping
    mapping: int = MAP_UV
    su: float = 1.0
    sv: float = 1.0
    du: float = 0.0
    dv: float = 0.0
    planar_v1: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    planar_v2: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    world_to_tex: np.ndarray = field(default_factory=lambda: np.eye(4))
    # image
    image_id: int = -1
    scale: float = 1.0
    # noise
    octaves: int = 8
    omega: float = 0.5


class TextureRegistry:
    """Host-side registry.  Float textures and RGB textures live in one list
    (float values broadcast over the channel dim), mirroring the two maps in
    renderprocess.rs:82-89 via the loader's name->id dicts."""

    def __init__(self):
        self.records: List[TexRecord] = []
        self.images: List[MIPMap] = []

    def add(self, rec: TexRecord) -> int:
        self.records.append(rec)
        return len(self.records) - 1

    def add_image(self, mip: MIPMap) -> int:
        self.images.append(mip)
        return len(self.images) - 1

    def device_images(self):
        # the packed coarse pyramid (~200 KB per image; MIPMap.as_packed)
        # is what image lookups read: on an H100 the textured bench row
        # renders 4x faster through it than through the exact per-window
        # gathers of mipmap.ewa_lookup, which stay as its test reference
        return [m.as_packed() for m in self.images]


def eval_all(registry: TextureRegistry, dev_images, uv, p_world, duv=None):
    """Evaluate every registered texture at each shading point.

    uv: (N,2); p_world: (N,3); duv: optional (N,4) = (dudx, dvdx, dudy,
    dvdy) screen-space footprints for filtered lookups.  Returns
    (n_tex, N, 3) stacked values.  Runs inside jit; registry is static.
    """
    n = uv.shape[0]
    outputs = []

    def footprint(rec, st_scale=(1.0, 1.0)):
        """(ds, dt) half-extents of the filter footprint in st space."""
        if duv is None:
            return None
        ds = jnp.maximum(jnp.abs(duv[:, 0]), jnp.abs(duv[:, 2])) * st_scale[0]
        dt = jnp.maximum(jnp.abs(duv[:, 1]), jnp.abs(duv[:, 3])) * st_scale[1]
        return ds, dt

    def get(idx, const):
        if idx >= 0:
            return outputs[idx]
        return jnp.broadcast_to(jnp.asarray(const, DTYPE), (n, 3))

    for rec in registry.records:
        if rec.kind == TEX_CONSTANT:
            val = jnp.broadcast_to(jnp.asarray(rec.value, DTYPE), (n, 3))
        elif rec.kind == TEX_SCALE:
            val = get(rec.t1, rec.t1_const) * get(rec.t2, rec.t2_const)
        elif rec.kind == TEX_MIX:
            amt = get(rec.amount, np.full(3, rec.amount_const))
            val = get(rec.t1, rec.t1_const) * (1.0 - amt) + get(rec.t2, rec.t2_const) * amt
        elif rec.kind == TEX_BILERP:
            st = _map_2d(rec, uv, p_world)
            s, t = st[..., 0:1], st[..., 1:2]
            val = (
                (1 - s) * (1 - t) * jnp.asarray(rec.v00, DTYPE)
                + (1 - s) * t * jnp.asarray(rec.v01, DTYPE)
                + s * (1 - t) * jnp.asarray(rec.v10, DTYPE)
                + s * t * jnp.asarray(rec.v11, DTYPE)
            )
        elif rec.kind == TEX_IMAGE:
            st = _map_2d(rec, uv, p_world)
            packed = dev_images[rec.image_id]
            if duv is not None and not registry.images[rec.image_id].do_trilinear:
                # EWA anisotropic filtering (imagemap default:
                # do_trilinear=False, renderprocess.rs:522)
                from .mipmap import packed_ewa_lookup

                su = rec.su if rec.mapping == MAP_UV else 1.0
                sv = rec.sv if rec.mapping == MAP_UV else 1.0
                dst0 = jnp.stack([duv[:, 0] * su, duv[:, 1] * sv], axis=-1)
                dst1 = jnp.stack([duv[:, 2] * su, duv[:, 3] * sv], axis=-1)
                val = packed_ewa_lookup(
                    packed, st, dst0, dst1,
                    registry.images[rec.image_id].max_aniso,
                ) * rec.scale
            else:
                from .mipmap import packed_trilinear_lookup

                fp = footprint(rec, (rec.su, rec.sv)) if rec.mapping == MAP_UV else footprint(rec)
                width = None
                if fp is not None:
                    width = 2.0 * jnp.maximum(fp[0], fp[1])
                val = packed_trilinear_lookup(packed, st, width) * rec.scale
        elif rec.kind == TEX_UV:
            st = _map_2d(rec, uv, p_world)
            val = jnp.stack(
                [
                    st[..., 0] - jnp.floor(st[..., 0]),
                    st[..., 1] - jnp.floor(st[..., 1]),
                    jnp.zeros_like(st[..., 0]),
                ],
                axis=-1,
            )
        elif rec.kind == TEX_CHECKER2D:
            st = _map_2d(rec, uv, p_world)
            t1v = get(rec.t1, rec.t1_const)
            t2v = get(rec.t2, rec.t2_const)
            parity = (
                jnp.floor(st[..., 0]).astype(jnp.int32)
                + jnp.floor(st[..., 1]).astype(jnp.int32)
            ) % 2
            point = jnp.where((parity == 0)[..., None], t1v, t2v)
            fp = footprint(rec, (rec.su, rec.sv)) if rec.mapping == MAP_UV else footprint(rec)
            if fp is None:
                val = point
            else:
                # closed-form box-filtered checkerboard
                # (texture/checkerboard.rs ClosedForm)
                ds = jnp.maximum(fp[0], 1e-8)
                dt = jnp.maximum(fp[1], 1e-8)
                s0, s1 = st[..., 0] - ds, st[..., 0] + ds
                t0, t1_ = st[..., 1] - dt, st[..., 1] + dt

                def bump_int(x):
                    xh = x / 2.0
                    return jnp.floor(xh) + 2.0 * jnp.maximum(
                        xh - jnp.floor(xh) - 0.5, 0.0
                    )

                sint = (bump_int(s1) - bump_int(s0)) / (2.0 * ds)
                tint = (bump_int(t1_) - bump_int(t0)) / (2.0 * dt)
                area2 = sint + tint - 2.0 * sint * tint
                area2 = jnp.where((ds > 1.0) | (dt > 1.0), 0.5, area2)
                filtered = (1.0 - area2)[..., None] * t1v + area2[..., None] * t2v
                inside_one = (
                    (jnp.floor(s0) == jnp.floor(s1))
                    & (jnp.floor(t0) == jnp.floor(t1_))
                )
                val = jnp.where(inside_one[..., None], point, filtered)
        elif rec.kind == TEX_CHECKER3D:
            pt = _apply44(rec.world_to_tex, p_world)
            parity = (
                jnp.floor(pt[..., 0]).astype(jnp.int32)
                + jnp.floor(pt[..., 1]).astype(jnp.int32)
                + jnp.floor(pt[..., 2]).astype(jnp.int32)
            ) % 2
            val = jnp.where(
                (parity == 0)[..., None],
                get(rec.t1, rec.t1_const),
                get(rec.t2, rec.t2_const),
            )
        elif rec.kind == TEX_WINDY:
            pt = _apply44(rec.world_to_tex, p_world)
            wind_strength = fbm(0.1 * pt, 3, 0.5)
            wave_height = fbm(pt, 6, 0.5)
            val = (jnp.abs(wind_strength) * wave_height)[..., None] * jnp.ones(
                (1, 3), DTYPE
            )
        elif rec.kind == TEX_WRINKLED:
            pt = _apply44(rec.world_to_tex, p_world)
            val = turbulence(pt, rec.octaves, rec.omega)[..., None] * jnp.ones(
                (1, 3), DTYPE
            )
        else:
            raise NotImplementedError(f"texture kind {rec.kind}")
        outputs.append(val.astype(DTYPE))

    if not outputs:
        return jnp.zeros((0, n, 3), DTYPE)
    return jnp.stack(outputs, axis=0)


def _apply44(m, p):
    m = jnp.asarray(m, DTYPE)
    return jnp.matmul(p, m[:3, :3].T, precision="highest") + m[:3, 3]


def _map_2d(rec, uv, p_world):
    """TextureMapping2D (texture/mod.rs:206-366)."""
    if rec.mapping == MAP_UV:
        return jnp.stack(
            [rec.su * uv[..., 0] + rec.du, rec.sv * uv[..., 1] + rec.dv], axis=-1
        )
    if rec.mapping == MAP_PLANAR:
        v1 = jnp.asarray(rec.planar_v1, DTYPE)
        v2 = jnp.asarray(rec.planar_v2, DTYPE)
        return jnp.stack(
            [vec.dot(p_world, v1) + rec.du, vec.dot(p_world, v2) + rec.dv], axis=-1
        )
    pt = _apply44(rec.world_to_tex, p_world)
    if rec.mapping == MAP_SPHERICAL:
        v = vec.normalize(pt)
        theta = jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(v[..., 1], v[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
        return jnp.stack([theta / np.pi, phi / (2 * np.pi)], axis=-1)
    if rec.mapping == MAP_CYLINDRICAL:
        phi = jnp.arctan2(pt[..., 1], pt[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
        return jnp.stack([phi / (2 * np.pi), pt[..., 2]], axis=-1)
    raise NotImplementedError


# ---- Perlin noise (texture/mod.rs:75-189) ----

_NOISE_PERM_SIZE = 256
_rng = np.random.default_rng(1337)
_PERM = np.concatenate([_rng.permutation(_NOISE_PERM_SIZE)] * 2).astype(np.int32)


def noise(p):
    """Classic Perlin gradient noise over (N,3) points.

    Same construction as the reference (hashed lattice gradients, smooth
    quintic interpolation); the permutation differs (seeded here) which only
    changes the (arbitrary) noise pattern, not its statistics.
    """
    perm = jnp.asarray(_PERM)
    pi = jnp.floor(p).astype(jnp.int32) & (_NOISE_PERM_SIZE - 1)
    pf = p - jnp.floor(p)

    def gradient(ix, iy, iz, fx, fy, fz):
        h = perm[perm[perm[ix] + iy] + iz] & 15
        u = jnp.where(h < 8, fx, fy)
        v = jnp.where(h < 4, fy, jnp.where((h == 12) | (h == 14), fx, fz))
        return jnp.where(h & 1 == 0, u, -u) + jnp.where(h & 2 == 0, v, -v)

    ix, iy, iz = pi[..., 0], pi[..., 1], pi[..., 2]
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(fx), fade(fy), fade(fz)
    g = lambda ox, oy, oz: gradient(
        (ix + ox) & (_NOISE_PERM_SIZE - 1),
        (iy + oy) & (_NOISE_PERM_SIZE - 1),
        (iz + oz) & (_NOISE_PERM_SIZE - 1),
        fx - ox,
        fy - oy,
        fz - oz,
    )
    lerp = lambda t, a, b: a + t * (b - a)
    x00 = lerp(u, g(0, 0, 0), g(1, 0, 0))
    x10 = lerp(u, g(0, 1, 0), g(1, 1, 0))
    x01 = lerp(u, g(0, 0, 1), g(1, 0, 1))
    x11 = lerp(u, g(0, 1, 1), g(1, 1, 1))
    y0 = lerp(v, x00, x10)
    y1 = lerp(v, x01, x11)
    return lerp(w, y0, y1)


def fbm(p, max_octaves, omega):
    """Fractional Brownian motion sum of noise octaves (texture/mod.rs)."""
    total = jnp.zeros(p.shape[:-1], DTYPE)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * noise(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, max_octaves, omega):
    total = jnp.zeros(p.shape[:-1], DTYPE)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * jnp.abs(noise(p * lam))
        lam *= 1.99
        o *= omega
    return total
