"""Vectorized BVH traversal on device (bvh.rs:183-236 equivalent).

Each ray walks the flat DFS BVH with its own fixed-depth stack; the whole
batch advances one node per `lax.while_loop` iteration with masked lanes
(rays whose stack emptied idle until all finish).  Near-node-first ordering
uses the stored split axis + ray direction sign like the reference.

Leaf primitive tests gather (kind, index) rows and run single-primitive
Möller-Trumbore / sphere tests per lane.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import DTYPE
from ..core.math import quadratic
from ..core.transform import apply_point_jnp, apply_vector_jnp
from .bvh import FlatBVH
from .geometry import Hit, PRIM_NONE, PRIM_SPHERE, PRIM_TRI, TRI_EPS

STACK_DEPTH = 48


def _tri_test(tri, rows, o, d, t_best):
    """Single-triangle Möller-Trumbore per lane; rows: (N,) indices."""
    p0 = tri.p0[rows]
    p1 = tri.p1[rows]
    p2 = tri.p2[rows]
    e1 = p1 - p0
    e2 = p2 - p0
    pv = jnp.cross(d, e2)
    det = jnp.sum(e1 * pv, axis=-1)
    ok = jnp.abs(det) >= TRI_EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tv = o - p0
    u = jnp.sum(tv * pv, axis=-1) * inv
    ok &= (u >= 0.0) & (u <= 1.0)
    qv = jnp.cross(tv, e1)
    v = jnp.sum(d * qv, axis=-1) * inv
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = jnp.sum(e2 * qv, axis=-1) * inv
    ok &= (t >= TRI_EPS) & (t < t_best)
    return jnp.where(ok, t, jnp.inf)


def _sphere_test(sph, rows, o, d, t_best):
    w2o = sph.w2o[rows]
    oo = apply_point_jnp(w2o, o)
    od = apply_vector_jnp(w2o, d)
    a = jnp.sum(od * od, axis=-1)
    b = 2.0 * jnp.sum(od * oo, axis=-1)
    c = jnp.sum(oo * oo, axis=-1) - sph.radius[rows] ** 2
    ok, t0, t1 = quadratic(a, b, c)

    def clip_ok(t):
        p = oo + od * t[..., None]
        z = jnp.clip(p[..., 2], -sph.radius[rows], sph.radius[rows])
        phi = jnp.arctan2(p[..., 1], p[..., 0])
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        zok = (z >= sph.z_min[rows] - 1e-6) & (z <= sph.z_max[rows] + 1e-6)
        return zok & (phi <= sph.phi_max[rows] + 1e-6)

    eps = 1e-4
    t0_ok = ok & (t0 > eps) & (t0 < t_best) & clip_ok(t0)
    t1_ok = ok & (t1 > eps) & (t1 < t_best) & clip_ok(t1)
    return jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, jnp.inf))


def intersect_bvh(bvh: FlatBVH, tri, sph, o, d, t_max, any_hit=False):
    """Closest-hit (or any-hit) traversal.  Returns Hit."""
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    neg = (inv_d < 0.0).astype(jnp.int32)  # per-axis sign (N,3)

    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pushed
    t_best = t_max.astype(DTYPE)
    best_kind = jnp.full((n,), PRIM_NONE, jnp.int32)
    best_idx = jnp.full((n,), -1, jnp.int32)
    found_any = jnp.zeros((n,), bool)

    def node_hit(node, t_best_):
        bmin = bvh.bounds_min[node]
        bmax = bvh.bounds_max[node]
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tn = jnp.minimum(t0, t1)
        tf = jnp.maximum(t0, t1)
        t_near = jnp.max(tn, axis=-1)
        t_far = jnp.min(tf, axis=-1) * 1.0000004  # reference-style slop
        return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best_)

    def cond(state):
        sp_, *_ = state
        live = sp_ > 0
        if any_hit:
            return jnp.any(live & ~state[5])
        return jnp.any(live)

    def body(state):
        sp_, stack_, t_best_, bk, bi, fa = state
        live = sp_ > 0
        if any_hit:
            live = live & ~fa
        sp_pop = jnp.where(live, sp_ - 1, sp_)
        node = stack_[jnp.arange(n), jnp.maximum(sp_pop, 0)]
        node = jnp.where(live, node, 0)

        hit_node = node_hit(node, t_best_) & live
        is_leaf = bvh.n_prims[node] > 0

        # --- leaf: test up to max_leaf prims ---
        pstart = bvh.offset[node]
        cnt = bvh.n_prims[node]
        for k in range(bvh.max_leaf):
            prow = jnp.clip(pstart + k, 0, bvh.prim_kind.shape[0] - 1)
            pk = bvh.prim_kind[prow]
            pi = bvh.prim_index[prow]
            do = hit_node & is_leaf & (k < cnt)
            if int(tri.count) > 0:
                t_tri = _tri_test(tri, jnp.clip(pi, 0, tri.count - 1), o, d, t_best_)
                upd = do & (pk == PRIM_TRI) & jnp.isfinite(t_tri)
                t_best_ = jnp.where(upd, t_tri, t_best_)
                bk = jnp.where(upd, PRIM_TRI, bk)
                bi = jnp.where(upd, pi, bi)
                fa = fa | upd
            if int(sph.count) > 0:
                t_sph = _sphere_test(
                    sph, jnp.clip(pi, 0, sph.count - 1), o, d, t_best_
                )
                upd = do & (pk == PRIM_SPHERE) & jnp.isfinite(t_sph)
                t_best_ = jnp.where(upd, t_sph, t_best_)
                bk = jnp.where(upd, PRIM_SPHERE, bk)
                bi = jnp.where(upd, pi, bi)
                fa = fa | upd

        # --- interior: push far child then near child ---
        axis = bvh.axis[node]
        near_is_left = jnp.take_along_axis(neg, axis[:, None], axis=1)[:, 0] == 0
        left = node + 1
        right = bvh.offset[node]
        near = jnp.where(near_is_left, left, right)
        far = jnp.where(near_is_left, right, left)
        push = hit_node & ~is_leaf
        # push far
        sp_new = sp_pop
        stack_ = stack_.at[jnp.arange(n), jnp.minimum(sp_new, STACK_DEPTH - 1)].set(
            jnp.where(push, far, stack_[jnp.arange(n), jnp.minimum(sp_new, STACK_DEPTH - 1)])
        )
        sp_new = jnp.where(push, jnp.minimum(sp_new + 1, STACK_DEPTH), sp_new)
        # push near
        stack_ = stack_.at[jnp.arange(n), jnp.minimum(sp_new, STACK_DEPTH - 1)].set(
            jnp.where(push, near, stack_[jnp.arange(n), jnp.minimum(sp_new, STACK_DEPTH - 1)])
        )
        sp_new = jnp.where(push, jnp.minimum(sp_new + 1, STACK_DEPTH), sp_new)
        return (sp_new, stack_, t_best_, bk, bi, fa)

    sp, stack, t_best, best_kind, best_idx, found_any = lax.while_loop(
        cond, body, (sp, stack, t_best, best_kind, best_idx, found_any)
    )
    valid = best_idx >= 0
    return Hit(t=t_best, kind=best_kind, index=best_idx, valid=valid)


def occluded_bvh(bvh, tri, sph, o, d, t_max):
    return intersect_bvh(bvh, tri, sph, o, d, t_max, any_hit=True).valid
