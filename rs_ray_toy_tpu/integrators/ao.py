"""Ambient-occlusion integrator (integrator/ao.rs).

First-hit occlusion probes: n_samples cosine- (or uniform-) hemisphere rays
from the first intersection; L = mean visibility (ao.rs:53-99).
"""

import jax.numpy as jnp

from ..config import DTYPE, INV_PI, INV_2_PI, PI
from ..core import vec
from ..core.sampling import cosine_sample_hemisphere, uniform_sample_hemisphere
from ..accel import geometry as geom
from ..bsdf import eval as beval
from .common import SceneCtx


def li_ao(ctx: SceneCtx, o, d, cam_weight, sampler, pixel_id, s_idx, spec):
    n = o.shape[0]
    t_max = jnp.full((n,), jnp.inf, DTYPE)
    hit = ctx.intersect(o, d, t_max)
    si = ctx.surface(hit, o, d)
    valid = si.valid & (cam_weight > 0.0)

    # build frame; flip normal to face wo (ao.rs does this with the shading
    # frame)
    ns = vec.faceforward(si.ns, si.wo)
    frame = beval.make_frame(ns, si.ng, si.dpdu)

    from jax import lax

    def body(k, total):
        u = sampler.get_2d(pixel_id, s_idx, 8 + k)
        if spec.cos_sample:
            w_local = cosine_sample_hemisphere(u)
            pdf = w_local[..., 2] * INV_PI
        else:
            w_local = uniform_sample_hemisphere(u)
            pdf = jnp.full((n,), INV_2_PI, DTYPE)
        w_world = beval.local_to_world(frame, w_local)
        origin = geom.offset_ray_origin(si.p, si.ng, w_world)
        occluded = ctx.occluded(origin, w_world, t_max)
        vis = (~occluded) & (pdf > 0.0)
        contrib = jnp.where(
            vis, vec.dot(w_world, ns) / jnp.maximum(pdf, 1e-20), 0.0
        )
        return total + contrib

    total = lax.fori_loop(0, spec.n_samples, body, jnp.zeros((n,), DTYPE))
    l = jnp.where(valid, total / (spec.n_samples * PI), 0.0)
    return jnp.tile(l[:, None], (1, ctx.n_channels))
