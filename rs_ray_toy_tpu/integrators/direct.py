"""Debug and DirectLighting integrators as wavefront level loops.

The reference's recursive li + specular_reflect/specular_transmit tree
(intersect_debug.rs:56-89, directlighting.rs:17-133,
integrator/mod.rs:150-301) becomes an iterative loop over depth levels:
each level carries a ray array with per-ray throughput beta; specular
reflection and transmission branches *double* the next level's ray array
(both children of every tree node), with dead branches masked by beta=0.
Small scenes keep 2^depth modest; compaction is a later perf phase.
"""

import jax.numpy as jnp

from ..config import DTYPE
from ..core import vec
from ..accel import geometry as geom
from ..bsdf import eval as beval
from ..bsdf.lobes import BXDF_REFLECTION, BXDF_SPECULAR, BXDF_TRANSMISSION
from ..lights import lights as lmod
from .common import (
    SceneCtx,
    uniform_sample_all_lights,
    uniform_sample_one_light,
)


def li_levels(ctx: SceneCtx, o, d, cam_weight, sampler, pixel_id, s_idx, spec, diff=None):
    """Evaluate radiance for camera rays under Debug / DirectLighting.

    Returns (N,3) radiance.  spec: IntegratorSpec (kind in debug|direct).
    """
    n = o.shape[0]
    max_depth = spec.max_depth
    debug = spec.kind == "debug"
    strategy_all = debug or spec.light_strategy == "all"
    # specular recursion only exists if some lobe carries BXDF_SPECULAR
    # (integrator/mod.rs:150-301 recursion is sample_f over SPECULAR|...)
    from ..bsdf.lobes import (
        LOBE_DEBUG_SPECULAR,
        LOBE_FRESNEL_SPEC,
        LOBE_SPEC_REFL,
        LOBE_SPEC_TRANS,
    )

    has_specular = bool(
        ctx.static_kinds
        & {LOBE_SPEC_REFL, LOBE_SPEC_TRANS, LOBE_FRESNEL_SPEC, LOBE_DEBUG_SPECULAR}
    )
    if not has_specular:
        max_depth = min(max_depth, 2)  # no children will ever contribute
    # per-branch static pruning: a child whose SPECULAR|REFLECTION (resp.
    # TRANSMISSION) sample_f can never match a lobe in the material table
    # is identically beta=0 — skip it and the level-doubling it causes.
    # Mirror-only scenes then keep a flat n-ray batch through all levels
    # instead of 2^depth (integrator/mod.rs:150-301 recursion tree, with
    # the zero subtrees statically removed).
    branch_live = (
        bool(ctx.static_kinds
             & {LOBE_SPEC_REFL, LOBE_FRESNEL_SPEC, LOBE_DEBUG_SPECULAR}),
        bool(ctx.static_kinds & {LOBE_SPEC_TRANS, LOBE_FRESNEL_SPEC}),
    )

    C = ctx.n_channels
    L = jnp.zeros((n, C), DTYPE)
    # level state
    lo, ld_, beta = o, d, jnp.ones((n, C), DTYPE)
    beta = beta * (cam_weight > 0.0)[:, None]
    lpix, lsamp = pixel_id, s_idx
    # per-ray dimension salt: tree branches at the same (pixel, sample) get
    # decorrelated sampler streams (the reference's sequential consumption
    # differs per branch the same way)
    branch = jnp.zeros((n,), jnp.int32)
    dim_off = 8  # dims 0-7 reserved for camera sample use
    depth = 1
    while True:
        dim_base = dim_off + branch * 257
        active = jnp.any(beta != 0.0, axis=-1)
        t_max = jnp.where(active, jnp.inf, 0.0).astype(DTYPE)
        hit = ctx.intersect(lo, ld_, t_max)
        si = ctx.surface(hit, lo, ld_)
        si = si._replace(valid=si.valid & active)
        duv = dpdx = dpdy = None
        if diff is not None:
            duv, dpdx, dpdy = geom.compute_uv_differentials(si, diff)
        params = ctx.shade_params(si, duv)
        frame = ctx.frame(si)

        level_l = jnp.zeros_like(beta)
        if debug:
            # flat base on any hit (intersect_debug.rs:69-72)
            level_l = level_l + jnp.where(
                si.valid[:, None], jnp.full((1, C), 0.1, DTYPE), 0.0
            )
        elif ctx.n_lights and ctx.infinite_envs:
            # escaped rays collect the FIRST light's le only — the
            # reference returns inside the first loop iteration
            # (directlighting.rs:83-88); le is nonzero only for infinite
            # lights, so this contributes iff lights[0] is one.
            import numpy as np

            if int(np.asarray(ctx.lights.kind)[0]) == lmod.LIGHT_INFINITE:
                env_id = int(np.asarray(ctx.lights.shape_index)[0])
                esc = active & ~hit.valid
                level_l = level_l + jnp.where(
                    esc[:, None],
                    lmod._env_lookup(ctx.infinite_envs[env_id], ld_),
                    0.0,
                )
        if strategy_all:
            s_l, dim_base = uniform_sample_all_lights(
                ctx, si, params, frame, sampler, lpix, lsamp, dim_base
            )
        else:
            s_l, dim_base = uniform_sample_one_light(
                ctx, si, params, frame, sampler, lpix, lsamp, dim_base
            )
        level_l = level_l + s_l
        L = _accumulate(L, n, beta * level_l)

        if depth + 1 >= max_depth:
            break
        if not (branch_live[0] or branch_live[1]):
            break  # no specular lobes anywhere: both subtrees are zero
        # specular reflect + transmit children (integrator/mod.rs:150-301)
        children = []
        child_diffs = []
        child_branches = []
        for ci, flags in enumerate(
            (
                BXDF_SPECULAR | BXDF_REFLECTION,
                BXDF_SPECULAR | BXDF_TRANSMISSION,
            )
        ):
            if not branch_live[ci]:
                continue  # statically zero subtree (see branch_live above)
            u = sampler.get_2d(lpix, lsamp, dim_base + ci)
            bs = beval.bsdf_sample(params, frame, si.wo, u, flags)
            contrib_ok = (
                si.valid
                & bs.valid
                & (vec.absdot(bs.wi_world, frame.ns) != 0.0)
            )
            child_beta = (
                beta
                * bs.f
                * (vec.absdot(bs.wi_world, frame.ns) / jnp.maximum(bs.pdf, 1e-20))[
                    :, None
                ]
            )
            child_beta = jnp.where(contrib_ok[:, None], child_beta, 0.0)
            child_o = geom.offset_ray_origin(si.p, si.ng, bs.wi_world)
            children.append((child_o, bs.wi_world, child_beta))
            child_branches.append(branch * 2 + (1 + ci))
            if diff is not None:
                # propagate the footprint through the specular child
                # (integrator/mod.rs:181-201 reflect, 237-295 transmit)
                if ci == 0:
                    child_diffs.append(
                        geom.specular_reflect_differentials(
                            si, duv, dpdx, dpdy, diff, bs.wi_world
                        )
                    )
                else:
                    child_diffs.append(
                        geom.specular_transmit_differentials(
                            si, duv, dpdx, dpdy, diff, bs.wi_world, params["eta"]
                        )
                    )
        nc = len(children)
        lo = jnp.concatenate([c[0] for c in children])
        ld_ = jnp.concatenate([c[1] for c in children])
        beta = jnp.concatenate([c[2] for c in children])
        lpix = jnp.concatenate([lpix] * nc)
        lsamp = jnp.concatenate([lsamp] * nc)
        if diff is not None:
            diff = tuple(
                jnp.concatenate([cd[k] for cd in child_diffs])
                for k in range(4)
            )
        # unique tree-node ids for sampler decorrelation (a pruned sibling
        # keeps the surviving child's id unchanged, so sampler streams are
        # identical to the unpruned tree's)
        branch = jnp.concatenate(child_branches)
        depth += 1

    return L


def _accumulate(L, n, contrib):
    """Fold a level's (k*n,C) contributions back onto the n camera rays."""
    k = contrib.shape[0] // n
    if k == 1:
        return L + contrib
    return L + jnp.sum(contrib.reshape(k, n, contrib.shape[-1]), axis=0)
