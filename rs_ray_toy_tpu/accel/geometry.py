"""Batched ray-primitive intersection (shape/triangle.rs, shape/sphere.rs).

All tests are data-parallel: a ray batch against primitive tables.  The
brute-force closest-hit here (vmapped all-pairs, fine for small scenes like
samples/scene.json's 36 triangles) shares its Hit layout with the BVH
traversal so integrators are oblivious to the accelerator.

Parity notes:
- Möller-Trumbore with the reference's epsilons (triangle.rs:167-180:
  determinant cutoff 1e-7, t cutoff 1e-7).  Unlike the reference's
  Shape::intersect (which ignores r.t_max — a §2.7-class quirk), we honour
  t_max, which is required for correct closest-hit in batch form and matches
  PBRT semantics.
- Sphere: quadratic in object space, z/phi clipping with the second-root
  retry (sphere.rs: the reference tests the clip on uninitialized state —
  quirk; we implement the PBRT-intended clip).
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..config import DTYPE
from ..core import vec
from ..core.math import quadratic
from ..core.transform import apply_normal_jnp, apply_point_jnp, apply_vector_jnp
from ..scene.types import SphereSoA, TriangleSoA

PRIM_NONE = -1
PRIM_TRI = 0
PRIM_SPHERE = 1

TRI_EPS = 1e-7


class Hit(NamedTuple):
    t: jnp.ndarray  # (N,) hit distance (t_max where no hit)
    kind: jnp.ndarray  # (N,) int32 PRIM_*
    index: jnp.ndarray  # (N,) int32 row in the table
    valid: jnp.ndarray  # (N,) bool


class SurfaceHit(NamedTuple):
    """Gathered shading geometry (interaction.rs SurfaceInteraction SoA)."""

    p: jnp.ndarray  # (N,3)
    ng: jnp.ndarray  # geometric normal
    ns: jnp.ndarray  # shading normal
    uv: jnp.ndarray  # (N,2)
    dpdu: jnp.ndarray  # (N,3)
    dpdv: jnp.ndarray
    wo: jnp.ndarray
    mat: jnp.ndarray  # (N,) int32
    area_light: jnp.ndarray  # (N,) int32
    valid: jnp.ndarray
    dndu: jnp.ndarray = None  # (N,3) shading-normal partials (triangle.rs:351-386)
    dndv: jnp.ndarray = None


def intersect_triangles(tri: TriangleSoA, o, d, t_max):
    """All-pairs Möller-Trumbore; returns per-ray closest (t, idx, hit).

    o,d: (N,3); t_max: (N,).  Memory: O(N*T); callers chunk N.
    """
    if tri.count == 0:
        n = o.shape[0]
        inf = jnp.full((n,), jnp.inf, DTYPE)
        return inf, jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool)
    e1 = (tri.p1 - tri.p0)[None]  # (1,T,3)
    e2 = (tri.p2 - tri.p0)[None]
    ob = o[:, None, :]  # (N,1,3)
    db = d[:, None, :]
    pv = jnp.cross(db, e2)  # (N,T,3)
    det = jnp.sum(e1 * pv, axis=-1)  # (N,T)
    ok = jnp.abs(det) >= TRI_EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tv = ob - tri.p0[None]
    u = jnp.sum(tv * pv, axis=-1) * inv
    ok &= (u >= 0.0) & (u <= 1.0)
    qv = jnp.cross(tv, e1)
    v = jnp.sum(db * qv, axis=-1) * inv
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = jnp.sum(e2 * qv, axis=-1) * inv
    ok &= (t >= TRI_EPS) & (t < t_max[:, None])
    t = jnp.where(ok, t, jnp.inf)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    tbest = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    hit = jnp.isfinite(tbest)
    return tbest, jnp.where(hit, idx, -1), hit


def intersect_triangles_any(tri: TriangleSoA, o, d, t_max):
    """Shadow-ray any-hit (triangle.rs IntersectP semantics, corrected
    edge basis)."""
    t, _, hit = intersect_triangles(tri, o, d, t_max)
    return hit


def _sphere_ray_object(sph: SphereSoA, o, d):
    """Transform rays into each sphere's object space: (N,S,3) pair."""
    w2o = sph.w2o  # (S,4,4)
    oo = apply_point_jnp(w2o[None], o[:, None])
    od = apply_vector_jnp(w2o[None], d[:, None])
    return oo, od


def intersect_spheres(sph: SphereSoA, o, d, t_max):
    """Quadratic + partial-sphere clip (sphere.rs:50-108 intent)."""
    if sph.count == 0:
        n = o.shape[0]
        inf = jnp.full((n,), jnp.inf, DTYPE)
        return inf, jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool)
    oo, od = _sphere_ray_object(sph, o, d)  # (N,S,3)
    a = jnp.sum(od * od, axis=-1)
    b = 2.0 * jnp.sum(od * oo, axis=-1)
    c = jnp.sum(oo * oo, axis=-1) - (sph.radius**2)[None]
    ok, t0, t1 = quadratic(a, b, c)

    def clip_ok(t):
        p = oo + od * t[..., None]
        # avoid exact-zero xy for phi
        z = jnp.clip(p[..., 2], -sph.radius[None], sph.radius[None])
        phi = jnp.arctan2(p[..., 1], p[..., 0])
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        zok = (z >= sph.z_min[None] - 1e-6) & (z <= sph.z_max[None] + 1e-6)
        return zok & (phi <= sph.phi_max[None] + 1e-6)

    eps = 1e-4
    t0_ok = ok & (t0 > eps) & (t0 < t_max[:, None]) & clip_ok(t0)
    t1_ok = ok & (t1 > eps) & (t1 < t_max[:, None]) & clip_ok(t1)
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, jnp.inf))
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    tbest = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    hit = jnp.isfinite(tbest)
    return tbest, jnp.where(hit, idx, -1), hit


def intersect_brute(tri: TriangleSoA, sph: SphereSoA, o, d, t_max):
    """Closest hit across all primitive tables."""
    tt, ti, th = intersect_triangles(tri, o, d, t_max)
    st, si, sh = intersect_spheres(sph, o, d, t_max)
    use_s = st < tt
    return Hit(
        t=jnp.minimum(tt, st),
        kind=jnp.where(use_s, PRIM_SPHERE, jnp.where(th, PRIM_TRI, PRIM_NONE)),
        index=jnp.where(use_s, si, ti),
        valid=th | sh,
    )


def occluded_brute(tri: TriangleSoA, sph: SphereSoA, o, d, t_max):
    hit = intersect_brute(tri, sph, o, d, t_max)
    return hit.valid




def pack_shade_tables(tri: TriangleSoA, sph: SphereSoA):
    """Concatenate per-primitive shading attributes into single tables so
    surface_interaction does ONE row selection per primitive type instead of
    ~15.  Build once per scene, not inside jit."""
    out = {}
    if tri.count > 0:
        # shading-normal partials (triangle.rs:351-386): per-triangle
        # constants, baked once.  Zero when the mesh has no vertex normals.
        duv02 = tri.uv0 - tri.uv2
        duv12 = tri.uv1 - tri.uv2
        dn1 = tri.n0 - tri.n2
        dn2 = tri.n1 - tri.n2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        degen = jnp.abs(det) < 1e-8
        i_det = 1.0 / jnp.where(degen, 1.0, det)
        dndu = (dn1 * duv12[:, 1:2] - dn2 * duv02[:, 1:2]) * i_det[:, None]
        dndv = (-dn1 * duv12[:, 0:1] + dn2 * duv02[:, 0:1]) * i_det[:, None]
        # degenerate UVs: arbitrary frame around the normal-variation axis
        dnc = jnp.cross(tri.n2 - tri.n0, tri.n1 - tri.n0)
        has_dn = vec.length_squared(dnc) > 0.0
        safe = vec.normalize(jnp.where(has_dn[:, None], dnc, jnp.asarray([0.0, 0.0, 1.0], DTYPE)))
        dnu_f, dnv_f = vec.coordinate_system(safe)
        dndu = jnp.where(degen[:, None], jnp.where(has_dn[:, None], dnu_f, 0.0), dndu)
        dndv = jnp.where(degen[:, None], jnp.where(has_dn[:, None], dnv_f, 0.0), dndv)
        flat = ~tri.has_n.astype(bool)
        dndu = jnp.where(flat[:, None], 0.0, dndu)
        dndv = jnp.where(flat[:, None], 0.0, dndv)
        out["tri_f"] = jnp.concatenate(
            [
                tri.p0, tri.p1, tri.p2,          # 0:9
                tri.uv0, tri.uv1, tri.uv2,       # 9:15
                tri.n0, tri.n1, tri.n2,          # 15:24
                tri.dpdu, tri.dpdv, tri.ng,      # 24:33
                dndu, dndv,                      # 33:39
            ],
            axis=1,
        )
        out["tri_i"] = jnp.stack(
            [tri.has_n.astype(jnp.int32), tri.mat, tri.area_light], axis=1
        )
    if sph.count > 0:
        out["sph_f"] = jnp.concatenate(
            [
                sph.w2o.reshape(-1, 16),         # 0:16
                sph.o2w.reshape(-1, 16),         # 16:32
                sph.radius[:, None],             # 32
                sph.phi_max[:, None],            # 33
                sph.theta_min[:, None],          # 34
                sph.theta_max[:, None],          # 35
            ],
            axis=1,
        )
        out["sph_i"] = jnp.stack([sph.mat, sph.area_light], axis=1)
    return out


def surface_interaction(
    tri: TriangleSoA, sph: SphereSoA, hit: Hit, o, d, shade_tables=None
) -> SurfaceHit:
    """Gather shading geometry for hits (triangle.rs:220-320 /
    sphere.rs Shape::intersect equivalents, SoA)."""
    from ..core.tableops import take_rows

    if shade_tables is None:
        shade_tables = pack_shade_tables(tri, sph)
    n = hit.t.shape[0]
    idx = jnp.maximum(hit.index, 0)
    t_safe = jnp.where(hit.valid, hit.t, 0.0)
    p_hit = o + d * t_safe[:, None]

    # --- triangle branch ---
    if tri.count > 0:
        ti = jnp.clip(idx, 0, tri.count - 1)
        tf = take_rows(shade_tables["tri_f"], ti)  # (N, 33)
        tii = take_rows(shade_tables["tri_i"], ti)  # (N, 3)
        p0, p1, p2 = tf[:, 0:3], tf[:, 3:6], tf[:, 6:9]
        uv0, uv1, uv2 = tf[:, 9:11], tf[:, 11:13], tf[:, 13:15]
        # recompute barycentrics from the stored hit (cheaper than carrying
        # u,v through the traversal)
        e1 = p1 - p0
        e2 = p2 - p0
        pv = jnp.cross(d, e2)
        det = jnp.sum(e1 * pv, axis=-1)
        inv = 1.0 / jnp.where(jnp.abs(det) < TRI_EPS, 1.0, det)
        tv = o - p0
        ub = jnp.sum(tv * pv, axis=-1) * inv
        qv = jnp.cross(tv, e1)
        vb = jnp.sum(d * qv, axis=-1) * inv
        w = 1.0 - ub - vb
        uv_hit_t = uv0 * w[:, None] + uv1 * ub[:, None] + uv2 * vb[:, None]
        # ray-independent partials baked at load (triangle.rs:276-299):
        # gather instead of recomputing per hit
        dpdu_t = tf[:, 24:27]
        dpdv_t = tf[:, 27:30]
        ng_t = tf[:, 30:33]
        dndu_t = tf[:, 33:36]
        dndv_t = tf[:, 36:39]
        # shading normal (triangle.rs:301+): interpolate + faceforward ng
        ns_raw = (
            tf[:, 15:18] * w[:, None]
            + tf[:, 18:21] * ub[:, None]
            + tf[:, 21:24] * vb[:, None]
        )
        has_n = (tii[:, 0] != 0) & (vec.length_squared(ns_raw) > 0.0)
        ns_t = jnp.where(has_n[:, None], vec.normalize(ns_raw), ng_t)
        # align geometric normal with shading normal (PBRT convention the
        # reference keeps via assert dot(n, ns) >= 0)
        ng_t = vec.faceforward(ng_t, ns_t)
        mat_t = tii[:, 1]
        al_t = tii[:, 2]
    else:
        z3 = jnp.zeros((n, 3), DTYPE)
        uv_hit_t = jnp.zeros((n, 2), DTYPE)
        dpdu_t = dpdv_t = ng_t = ns_t = dndu_t = dndv_t = z3
        mat_t = jnp.full((n,), -1, jnp.int32)
        al_t = jnp.full((n,), -1, jnp.int32)

    # --- sphere branch ---
    if sph.count > 0:
        si = jnp.clip(idx, 0, sph.count - 1)
        sf = take_rows(shade_tables["sph_f"], si)  # (N, 36)
        sii = take_rows(shade_tables["sph_i"], si)  # (N, 2)
        w2o = sf[:, 0:16].reshape(-1, 4, 4)
        o2w = sf[:, 16:32].reshape(-1, 4, 4)
        po = apply_point_jnp(w2o, p_hit)
        radius = sf[:, 32]
        # reproject (sphere.rs does p_hit *= radius / |p_hit|)
        po = po * (radius / jnp.maximum(vec.length(po), 1e-30))[:, None]
        phi = jnp.arctan2(po[:, 1], po[:, 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        theta = jnp.arccos(jnp.clip(po[:, 2] / radius, -1.0, 1.0))
        phi_max = sf[:, 33]
        # NOTE theta_min corresponds to z_min (theta decreasing in z)
        th_min = sf[:, 34]
        th_max = sf[:, 35]
        u_s = phi / phi_max
        v_s = (theta - th_min) / jnp.where(th_max == th_min, 1.0, th_max - th_min)
        uv_hit_s = jnp.stack([u_s, v_s], axis=-1)
        z_r = jnp.sqrt(jnp.maximum(po[:, 0] ** 2 + po[:, 1] ** 2, 1e-20))
        inv_zr = 1.0 / z_r
        cos_phi = po[:, 0] * inv_zr
        sin_phi = po[:, 1] * inv_zr
        dpdu_o = jnp.stack(
            [-phi_max * po[:, 1], phi_max * po[:, 0], jnp.zeros_like(phi)], axis=-1
        )
        dth = th_max - th_min
        dpdv_o = (
            jnp.stack(
                [po[:, 2] * cos_phi, po[:, 2] * sin_phi, -radius * jnp.sin(theta)],
                axis=-1,
            )
            * dth[:, None]
        )
        dpdu_s = apply_vector_jnp(o2w, dpdu_o)
        dpdv_s = apply_vector_jnp(o2w, dpdv_o)
        # normal: object-space position transformed as a normal
        ng_raw = apply_normal_jnp(w2o, po)
        ng_len = jnp.maximum(vec.length(ng_raw), 1e-30)
        ng_s = ng_raw / ng_len[:, None]
        # sphere normal partials: n = p/r object-space, so dn/du = dpdu/r
        # exactly (the Weingarten form of sphere.rs:215-243 reduces to
        # this); transformed as normals and scaled by the normalization
        dndu_s = apply_normal_jnp(w2o, dpdu_o) / ng_len[:, None]
        dndv_s = apply_normal_jnp(w2o, dpdv_o) / ng_len[:, None]
        mat_s = sii[:, 0]
        al_s = sii[:, 1]
    else:
        z3 = jnp.zeros((n, 3), DTYPE)
        uv_hit_s = jnp.zeros((n, 2), DTYPE)
        dpdu_s = dpdv_s = ng_s = dndu_s = dndv_s = z3
        mat_s = jnp.full((n,), -1, jnp.int32)
        al_s = jnp.full((n,), -1, jnp.int32)

    is_sph = (hit.kind == PRIM_SPHERE)[:, None]
    uv = jnp.where(is_sph, uv_hit_s, uv_hit_t)
    dpdu = jnp.where(is_sph, dpdu_s, dpdu_t)
    dpdv = jnp.where(is_sph, dpdv_s, dpdv_t)
    ng = jnp.where(is_sph, ng_s, ng_t)
    ns = jnp.where(is_sph, ng_s, ns_t)
    dndu = jnp.where(is_sph, dndu_s, dndu_t)
    dndv = jnp.where(is_sph, dndv_s, dndv_t)
    mat = jnp.where(hit.kind == PRIM_SPHERE, mat_s, mat_t)
    al = jnp.where(hit.kind == PRIM_SPHERE, al_s, al_t)

    return SurfaceHit(
        p=p_hit,
        ng=ng,
        ns=ns,
        uv=uv,
        dpdu=dpdu,
        dpdv=dpdv,
        wo=-d,
        mat=jnp.where(hit.valid, mat, -1),
        area_light=jnp.where(hit.valid, al, -1),
        valid=hit.valid,
        dndu=dndu,
        dndv=dndv,
    )


def offset_ray_origin(p, n, w):
    """Spawn-ray origin offsetting.  The reference offsets along the normal
    by an error-bound distance (geometry.rs:721-749); with f32 device math a
    fixed scaled epsilon on top of the position magnitude is the standard
    robust equivalent."""
    mag = jnp.sum(jnp.abs(p), axis=-1, keepdims=True)
    eps = (1e-4 + 1e-5 * mag)
    off = jnp.where(vec.dot(w, n)[:, None] < 0.0, -eps, eps)
    return p + n * off


def compute_uv_differentials(si: SurfaceHit, diff):
    """Ray-differential UV footprints (interaction.rs:223-284).

    diff: (rx_o, rx_d, ry_o, ry_d) auxiliary rays.  Intersect them
    with the tangent plane at p, project the offsets onto (dpdu, dpdv) via
    the least-squares 2x2 solve.  Returns (duv, dpdx, dpdy) where duv is
    (N,4) = (dudx, dvdx, dudy, dvdy) and dpdx/dpdy are the (N,3) world
    footprint vectors (needed by the specular-chain propagation).

    (The reference's ty uses d(n . ry_direction) in place of
    d(n . ry_origin) — SURVEY §2.7; the PBRT-intended form is used.)
    """
    rx_o, rx_d, ry_o, ry_d = diff
    n = si.ng
    d_plane = vec.dot(n, si.p)

    def plane_hit(o, dd):
        denom = vec.dot(n, dd)
        t = (d_plane - vec.dot(n, o)) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        return o + dd * t[:, None]

    px = plane_hit(rx_o, rx_d)
    py = plane_hit(ry_o, ry_d)
    dpdx = px - si.p
    dpdy = py - si.p

    # choose the two dominant axes of n for the 2x2 system
    ax = jnp.abs(n)
    # dim = argmax |n| excluded
    kmax = jnp.argmax(ax, axis=-1)
    dim0 = jnp.where(kmax == 0, 1, 0)
    dim1 = jnp.where(kmax == 2, 1, 2)

    def col(v, k):
        # v[:, k] for per-row k in {0,1,2} as a select chain (no gather)
        return jnp.where(
            k == 0, v[:, 0], jnp.where(k == 1, v[:, 1], v[:, 2])
        )

    def solve(dp):
        a00 = col(si.dpdu, dim0)
        a01 = col(si.dpdv, dim0)
        a10 = col(si.dpdu, dim1)
        a11 = col(si.dpdv, dim1)
        b0 = col(dp, dim0)
        b1 = col(dp, dim1)
        det = a00 * a11 - a01 * a10
        ok = jnp.abs(det) >= 1e-10
        inv = 1.0 / jnp.where(ok, det, 1.0)
        du = (a11 * b0 - a01 * b1) * inv
        dv = (a00 * b1 - a10 * b0) * inv
        return jnp.where(ok, du, 0.0), jnp.where(ok, dv, 0.0)

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    fin = lambda x: jnp.where(jnp.isfinite(x) & si.valid, x, 0.0)
    duv = jnp.stack([fin(dudx), fin(dvdx), fin(dudy), fin(dvdy)], axis=-1)
    fin3 = lambda x: jnp.where(
        jnp.isfinite(x).all(-1, keepdims=True) & si.valid[:, None], x, 0.0
    )
    return duv, fin3(dpdx), fin3(dpdy)


def dead_differentials(o, d):
    """Differential rays equal to the main ray: zero footprint, so EWA
    degenerates to a point-sampled lookup (the reference's
    has_differentials=false fallback)."""
    return (o, d, o, d)


def specular_reflect_differentials(si: SurfaceHit, duv, dpdx, dpdy, diff, wi):
    """Reflected-chain ray differentials (integrator/mod.rs:181-201).

    diff: incoming (rx_o, rx_d, ry_o, ry_d); returns the child's tuple.
    NOTE mod.rs:198-200 scales the normal term by 0.2 where PBRT v3 has
    2.0 (a transcription slip, footprint-only — no estimator effect); the
    PBRT-intended factor is used (docs/PARITY.md).
    """
    rx_o, rx_d, ry_o, ry_d = diff
    ns = si.ns
    wo = si.wo
    dndx = si.dndu * duv[:, 0:1] + si.dndv * duv[:, 1:2]
    dndy = si.dndu * duv[:, 2:3] + si.dndv * duv[:, 3:4]
    dwodx = -rx_d - wo
    dwody = -ry_d - wo
    ddndx = vec.dot(dwodx, ns) + vec.dot(wo, dndx)
    ddndy = vec.dot(dwody, ns) + vec.dot(wo, dndy)
    won = vec.dot(wo, ns)[:, None]
    new_rx_d = wi - dwodx + 2.0 * (dndx * won + ns * ddndx[:, None])
    new_ry_d = wi - dwody + 2.0 * (dndy * won + ns * ddndy[:, None])
    return (si.p + dpdx, new_rx_d, si.p + dpdy, new_ry_d)


def specular_transmit_differentials(si: SurfaceHit, duv, dpdx, dpdy, diff, wi, eta_mat):
    """Transmitted-chain ray differentials (integrator/mod.rs:237-295).

    eta_mat: (N,) interior IOR stored on the Bsdf (bsdf.eta)."""
    rx_o, rx_d, ry_o, ry_d = diff
    wo = si.wo
    won0 = vec.dot(wo, si.ns)
    entering = won0 >= 0.0
    flip = jnp.where(entering, 1.0, -1.0)[:, None]
    ns = si.ns * flip
    eta = jnp.where(entering, 1.0 / eta_mat, eta_mat)
    dndx = (si.dndu * duv[:, 0:1] + si.dndv * duv[:, 1:2]) * flip
    dndy = (si.dndu * duv[:, 2:3] + si.dndv * duv[:, 3:4]) * flip
    dwodx = -rx_d - wo
    dwody = -ry_d - wo
    ddndx = vec.dot(dwodx, ns) + vec.dot(wo, dndx)
    ddndy = vec.dot(dwody, ns) + vec.dot(wo, dndy)
    won = vec.dot(wo, ns)
    win = jnp.maximum(vec.absdot(wi, ns), 1e-9)
    mu = eta * won - win
    dfac = eta - (eta * eta * won) / win
    new_rx_d = wi - dwodx * eta[:, None] + (dndx * mu[:, None] + ns * (ddndx * dfac)[:, None])
    new_ry_d = wi - dwody * eta[:, None] + (dndy * mu[:, None] + ns * (ddndy * dfac)[:, None])
    return (si.p + dpdx, new_rx_d, si.p + dpdy, new_ry_d)
