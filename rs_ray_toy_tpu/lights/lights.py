"""Batched light sampling (lights/).

sample_li is a typed switch over the light table, returning per-ray
(radiance, wi, pdf, p_light) — the visibility test is a separate shadow-ray
batch through the intersector, replacing VisibilityTester
(lights/mod.rs:55-100).

Kinds: point (lights/point.rs), distant (lights/distant.rs), diffuse area
over spheres / single triangles (lights/diffuse.rs + shape/mod.rs
sample_ref), infinite environment maps (lights/infinite.rs).

Reference quirks (see docs/PARITY.md):
- Shape::sample_ref overwrites the pdf with dist^2/|cos| instead of
  multiplying the 1/area in (shape/mod.rs:33-47) — replicated behind
  AREA_PDF_QUIRK for estimator parity.
- Triangle::sample draws "barycentrics" from uniform_sample_sphere
  (triangle.rs sample) — we use proper uniform triangle sampling.
- InfiniteAreaLight::pdf_li transforms with to_world (should be to_local)
  and divides the lookup *point* by 2pi^2 sin(theta)
  (lights/infinite.rs:203-204) — fixed here (PBRT-intended math).
"""

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE, PI
from ..core import vec
from ..core.sampling import pdf_2d, sample_continuous_2d, uniform_sample_sphere
from ..core.transform import apply_normal_jnp, apply_point_jnp, apply_vector_jnp
from ..scene.types import (
    AREA_SHAPE_SPHERE,
    AREA_SHAPE_TRIANGLE,
    LIGHT_DIFFUSE_AREA,
    LIGHT_DISTANT,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LightSoA,
)

AREA_PDF_QUIRK = True  # replicate shape/mod.rs:33-47's missing 1/area


def is_delta(kind):
    return (kind == LIGHT_POINT) | (kind == LIGHT_DISTANT)


class LiSample(NamedTuple):
    li: jnp.ndarray  # (N,3)
    wi: jnp.ndarray  # (N,3)
    pdf: jnp.ndarray  # (N,)
    p_light: jnp.ndarray  # (N,3) shadow-ray target
    dist_scale: jnp.ndarray  # (N,)


def _env_lookup(env, w_world):
    """Env radiance along world directions (infinite.rs le):
    (u,v) = (phi/2pi, theta/pi) in light space."""
    from ..scene.mipmap import trilinear_lookup

    m = env["to_local"]
    w = vec.normalize(jnp.matmul(w_world, m[:3, :3].T, precision="highest"))
    theta = jnp.arccos(jnp.clip(w[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(w[..., 1], w[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    st = jnp.stack([phi / (2.0 * PI), theta / PI], axis=-1)
    return trilinear_lookup(env["mipmap"], st)


def le_escape(infinite_envs, d):
    """Sum of infinite-light le along escaped rays (path.rs:84-87).
    Only the `infinite_lights`-section envs contribute — the reference's
    escape loop reads scene.infinite_lights, not scene.lights."""
    c = infinite_envs[0]["mipmap"]["channels"] if infinite_envs else 3
    total = jnp.zeros(d.shape[:-1] + (c,), DTYPE)
    for env in infinite_envs:
        if env.get("escape_le", False):
            total = total + _env_lookup(env, d)
    return total


def sample_li(lights: LightSoA, infinite_envs, light_idx, p_ref, u):
    """Per-ray light sample: light_idx (N,) into the table, p_ref (N,3)
    shading points, u (N,2) uniforms."""
    from ..core.tableops import take_rows

    _row = lambda a: take_rows(a, light_idx)
    kind = _row(lights.kind)
    emit = _row(lights.emit)
    n = p_ref.shape[0]

    # ---- point (lights/point.rs:55-79): I / r^2, delta pdf = 1 ----
    p_l = _row(lights.p)
    to_l = p_l - p_ref
    dist2 = jnp.maximum(vec.length_squared(to_l), 1e-20)
    wi = to_l / jnp.sqrt(dist2)[..., None]
    li = emit / dist2[..., None]
    p_light = p_l
    pdf = jnp.where(is_delta(kind), 1.0, 0.0).astype(DTYPE)

    # ---- distant (lights/distant.rs:66-91) ----
    is_dist = (kind == LIGHT_DISTANT)[..., None]
    w_dir = _row(lights.w_light)
    wi = jnp.where(is_dist, w_dir, wi)
    li = jnp.where(is_dist, emit, li)
    p_light = jnp.where(is_dist, p_ref + w_dir * (2.0 * lights.world_radius), p_light)

    # ---- diffuse area (lights/diffuse.rs sample_li + shape sample_ref) ----
    has_area = bool(np.any(np.asarray(lights.kind) == LIGHT_DIFFUSE_AREA)) if lights.count else False
    if has_area:
        sk = _row(lights.shape_kind)
        # sphere: uniform point on the full sphere (sphere.rs sample)
        o2w = _row(lights.sph_o2w)
        w2o = _row(lights.sph_w2o)
        radius = _row(lights.sph_radius)
        p_obj = uniform_sample_sphere(u) * radius[..., None]
        p_sph = apply_point_jnp(o2w, p_obj)
        n_sph = vec.normalize(apply_normal_jnp(w2o, p_obj))
        # triangle: uniform barycentric (PBRT-intended; see module doc)
        su = jnp.sqrt(jnp.maximum(u[..., 0], 0.0))
        b0 = 1.0 - su
        b1 = u[..., 1] * su
        tp = _row(lights.tri_p)
        p_tri = (
            tp[:, 0] * b0[..., None]
            + tp[:, 1] * b1[..., None]
            + tp[:, 2] * (1.0 - b0 - b1)[..., None]
        )
        n_tri = vec.normalize(
            jnp.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0])
        )
        is_tri = (sk == AREA_SHAPE_TRIANGLE)[..., None]
        p_shape = jnp.where(is_tri, p_tri, p_sph)
        n_shape = jnp.where(is_tri, n_tri, n_sph)

        to_s = p_shape - p_ref
        d2 = vec.length_squared(to_s)
        wi_a = to_s / jnp.sqrt(jnp.maximum(d2, 1e-20))[..., None]
        cos_l = vec.absdot(-wi_a, n_shape)
        pdf_a = d2 / jnp.maximum(cos_l, 1e-20)
        if not AREA_PDF_QUIRK:
            pdf_a = pdf_a / jnp.maximum(_row(lights.area), 1e-20)
        pdf_a = jnp.where((d2 > 0.0) & jnp.isfinite(pdf_a), pdf_a, 0.0)
        # one-sided emission (diffuse.rs l(): emit iff dot(n, w) > 0)
        front = vec.dot(n_shape, -wi_a) > 0.0
        li_a = jnp.where(front[..., None], emit, 0.0)

        is_area = (kind == LIGHT_DIFFUSE_AREA)[..., None]
        wi = jnp.where(is_area, wi_a, wi)
        li = jnp.where(is_area, li_a, li)
        p_light = jnp.where(is_area, p_shape, p_light)
        pdf = jnp.where(is_area[..., 0], pdf_a, pdf)

    # ---- infinite (lights/infinite.rs:140-186) ----
    for env_id, env in enumerate(infinite_envs):
        sel = (kind == LIGHT_INFINITE) & (_row(lights.shape_index) == env_id)
        if not bool(np.any(np.asarray(lights.shape_index) == env_id)):
            continue
        uv, map_pdf = sample_continuous_2d(env["dist"], u)
        theta = uv[..., 1] * PI
        phi = uv[..., 0] * 2.0 * PI
        sin_t = jnp.sin(theta)
        w_local = jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)], axis=-1
        )
        m = env["to_world"]
        wi_e = jnp.matmul(w_local, m[:3, :3].T, precision="highest")
        pdf_e = jnp.where(
            sin_t > 0.0, map_pdf / (2.0 * PI * PI * jnp.maximum(sin_t, 1e-9)), 0.0
        )
        from ..scene.mipmap import trilinear_lookup

        li_e = trilinear_lookup(env["mipmap"], uv)
        wi = jnp.where(sel[..., None], wi_e, wi)
        li = jnp.where(sel[..., None], li_e, li)
        pdf = jnp.where(sel, pdf_e, pdf)
        p_light = jnp.where(
            sel[..., None], p_ref + wi_e * (2.0 * lights.world_radius), p_light
        )

    supported = (
        is_delta(kind) | (kind == LIGHT_DIFFUSE_AREA) | (kind == LIGHT_INFINITE)
    )
    return LiSample(
        li=jnp.where(supported[..., None], li, 0.0),
        wi=wi,
        pdf=jnp.where(supported, pdf, 0.0),
        p_light=p_light,
        dist_scale=jnp.ones_like(pdf),
    )


def pdf_li(lights: LightSoA, infinite_envs, light_idx, p_ref, wi):
    """Light::pdf_li for the BSDF-sampling MIS branch."""
    from ..core.tableops import take_rows

    _row = lambda a: take_rows(a, light_idx)
    kind = _row(lights.kind)
    pdf = jnp.zeros(light_idx.shape, DTYPE)

    has_area = bool(np.any(np.asarray(lights.kind) == LIGHT_DIFFUSE_AREA)) if lights.count else False
    if has_area:
        # Shape::pdf_ref (shape/mod.rs:50-66): intersect the shape along wi
        # analytically
        # sphere
        w2o = _row(lights.sph_w2o)
        oo = apply_point_jnp(w2o, p_ref)
        od = apply_vector_jnp(w2o, wi)
        a = vec.length_squared(od)
        b = 2.0 * vec.dot(od, oo)
        c = vec.length_squared(oo) - _row(lights.sph_radius) ** 2
        disc = b * b - 4 * a * c
        hit_s = disc > 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        q = jnp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        t0 = q / jnp.maximum(a, 1e-20)
        t1 = c / jnp.where(q == 0, 1.0, q)
        tt = jnp.where(jnp.minimum(t0, t1) > 1e-4, jnp.minimum(t0, t1), jnp.maximum(t0, t1))
        hit_s &= tt > 1e-4
        p_hit_o = oo + od * tt[..., None]
        o2w = _row(lights.sph_o2w)
        p_hit_s = apply_point_jnp(o2w, p_hit_o)
        n_hit_s = vec.normalize(apply_normal_jnp(w2o, p_hit_o))
        # triangle
        tp = _row(lights.tri_p)
        e1 = tp[:, 1] - tp[:, 0]
        e2 = tp[:, 2] - tp[:, 0]
        pv = jnp.cross(wi, e2)
        det = vec.dot(e1, pv)
        inv = 1.0 / jnp.where(jnp.abs(det) < 1e-9, 1.0, det)
        tv = p_ref - tp[:, 0]
        uu = vec.dot(tv, pv) * inv
        qv = jnp.cross(tv, e1)
        vv = vec.dot(wi, qv) * inv
        tt_t = vec.dot(e2, qv) * inv
        hit_t = (
            (jnp.abs(det) >= 1e-9)
            & (uu >= 0)
            & (uu <= 1)
            & (vv >= 0)
            & (uu + vv <= 1)
            & (tt_t > 1e-4)
        )
        p_hit_t = p_ref + wi * tt_t[..., None]
        n_hit_t = vec.normalize(jnp.cross(e1, e2))

        is_tri = _row(lights.shape_kind) == AREA_SHAPE_TRIANGLE
        hit = jnp.where(is_tri, hit_t, hit_s)
        p_hit = jnp.where(is_tri[..., None], p_hit_t, p_hit_s)
        n_hit = jnp.where(is_tri[..., None], n_hit_t, n_hit_s)
        d2 = vec.length_squared(p_ref - p_hit)
        denom = vec.absdot(-wi, n_hit) * _row(lights.area)
        pdf_a = jnp.where(hit & (denom > 0.0), d2 / jnp.maximum(denom, 1e-20), 0.0)
        pdf = jnp.where(kind == LIGHT_DIFFUSE_AREA, pdf_a, pdf)

    for env_id, env in enumerate(infinite_envs):
        sel = (kind == LIGHT_INFINITE) & (_row(lights.shape_index) == env_id)
        if not bool(np.any(np.asarray(lights.shape_index) == env_id)):
            continue
        m = env["to_local"]
        w = vec.normalize(jnp.matmul(wi, m[:3, :3].T, precision="highest"))
        theta = jnp.arccos(jnp.clip(w[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(w[..., 1], w[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * PI, phi)
        sin_t = jnp.sin(theta)
        st = jnp.stack([phi / (2 * PI), theta / PI], axis=-1)
        pdf_e = jnp.where(
            sin_t > 0.0,
            pdf_2d(env["dist"], st) / (2.0 * PI * PI * jnp.maximum(sin_t, 1e-9)),
            0.0,
        )
        pdf = jnp.where(sel, pdf_e, pdf)
    return pdf


def power(lights: LightSoA):
    """Light::power batched — used by the power light distribution
    (integrator/mod.rs:560-571) and SPPM photon emission.
    point: 4*pi*I (point.rs:82-84); distant/infinite: pi*r^2*L
    (distant.rs / infinite.rs:188-191); area: L*area*pi (diffuse.rs)."""
    from ..core.spectrum import lum_any as luminance

    r = lights.world_radius
    y = luminance(lights.emit)
    pw = 4.0 * PI * y  # point
    pw = jnp.where(lights.kind == LIGHT_DISTANT, PI * r * r * y, pw)
    pw = jnp.where(lights.kind == LIGHT_DIFFUSE_AREA, y * lights.area * PI, pw)
    pw = jnp.where(lights.kind == LIGHT_INFINITE, PI * r * r * y, pw)
    return pw
