"""Wavefront unidirectional path tracer (integrator/path.rs).

The recursive bounce loop (path.rs:51-226) becomes a masked megabatch loop:
all rays advance one bounce per iteration with an active mask; emitted-light
rules (bounce-0/specular), NEE with the uniform light distribution
(path.rs:47-49), throughput update, etaScale-corrected Russian roulette
after bounce 3 (path.rs:212-222) all match the reference estimator.

Notes:
- isect.le() is always zero in the reference because the aggregate never
  links area lights into primitives (renderprocess.rs:1192); escaped rays
  collect infinite_lights le (none wired yet -> zero contribution).
- BSSRDF branch lands with the Disney/BSSRDF phase.
- Stream compaction/sorting is a perf phase; the mask form is estimator-
  exact already.
"""

import jax.numpy as jnp

from ..config import DTYPE, PI
from ..core import vec
from ..accel import geometry as geom
from ..bsdf import eval as beval
from ..bsdf.lobes import BXDF_ALL, BXDF_SPECULAR, BXDF_TRANSMISSION
from .common import SceneCtx, uniform_sample_one_light


def li_path(ctx: SceneCtx, o, d, cam_weight, sampler, pixel_id, s_idx, spec, diff=None):
    n = o.shape[0]
    C = ctx.n_channels
    L = jnp.zeros((n, C), DTYPE)
    beta = jnp.ones((n, C), DTYPE) * (cam_weight > 0.0)[:, None]
    active = cam_weight > 0.0
    specular_bounce = jnp.zeros((n,), bool)
    eta_scale = jnp.ones((n,), DTYPE)
    ro, rd = o, d

    from ..sampler import dims as sdims

    for bounces in range(spec.max_depth + 1):
        dim0 = sdims.path_dim0(bounces)
        # dead lanes get t_max = 0, so traversal culls them at the root
        t_max = jnp.where(active, jnp.inf, 0.0).astype(DTYPE)
        hit = ctx.intersect(ro, rd, t_max)
        si = ctx.surface(hit, ro, rd)
        found = hit.valid & active

        # emitted light at vertex 0 / after specular (path.rs:79-88):
        # surface le is identically zero (module docstring); escaped rays
        # collect infinite-light le.
        if ctx.infinite_envs:
            from ..lights.lights import le_escape

            collect = active & ~found
            if bounces > 0:
                collect = collect & specular_bounce
            L = L + jnp.where(
                collect[:, None], beta * le_escape(ctx.infinite_envs, rd), 0.0
            )

        # terminate: escaped or depth exhausted (path.rs:91-93)
        active = active & found & (bounces < spec.max_depth)
        if bounces == spec.max_depth:
            break

        si = si._replace(valid=si.valid & active)
        duv = dpdx = dpdy = None
        if diff is not None:
            duv, dpdx, dpdy = geom.compute_uv_differentials(si, diff)
        params = ctx.shade_params(si, duv)
        frame = ctx.frame(si)

        # NEE unless the BSDF is purely specular (path.rs:108-122)
        n_nonspec = beval.num_components(params, BXDF_ALL & ~BXDF_SPECULAR)
        si_nee = si._replace(valid=si.valid & (n_nonspec > 0))
        ld, _ = uniform_sample_one_light(
            ctx, si_nee, params, frame, sampler, pixel_id, s_idx, dim0
        )
        L = L + beta * ld

        # sample BSDF for the next direction (path.rs:125-148)
        u_bsdf = sampler.get_2d(pixel_id, s_idx, dim0 + sdims.PATH_BSDF)
        bs = beval.bsdf_sample(params, frame, si.wo, u_bsdf, BXDF_ALL)
        ok = active & bs.valid & jnp.any(bs.f != 0.0, axis=-1) & (bs.pdf > 0.0)
        beta_next = (
            beta
            * bs.f
            * (vec.absdot(bs.wi_world, frame.ns) / jnp.maximum(bs.pdf, 1e-20))[:, None]
        )
        beta = jnp.where(ok[:, None], beta_next, beta)
        active = active & ok
        specular_bounce = (bs.sampled_flags & BXDF_SPECULAR) != 0

        # etaScale tracking (path.rs:150-163)
        is_spec_trans = (
            ((bs.sampled_flags & BXDF_SPECULAR) != 0)
            & ((bs.sampled_flags & BXDF_TRANSMISSION) != 0)
        )
        eta = params["eta"]
        entering = vec.dot(si.wo, si.ng) > 0.0
        eta_fac = jnp.where(entering, eta * eta, 1.0 / jnp.maximum(eta * eta, 1e-20))
        eta_scale = jnp.where(active & is_spec_trans, eta_scale * eta_fac, eta_scale)

        ro = jnp.where(
            active[:, None], geom.offset_ray_origin(si.p, si.ng, bs.wi_world), ro
        )
        rd = jnp.where(active[:, None], bs.wi_world, rd)

        # footprint propagation through specular bounces (beyond the
        # reference, whose path.rs drops differentials after the primary
        # hit): keeps EWA texture filtering sharp through mirrors/glass.
        if diff is not None and ctx.uses_textures:
            refl_diff = geom.specular_reflect_differentials(
                si, duv, dpdx, dpdy, diff, bs.wi_world
            )
            trans_diff = geom.specular_transmit_differentials(
                si, duv, dpdx, dpdy, diff, bs.wi_world, params["eta"]
            )
            dead = geom.dead_differentials(ro, rd)
            spec_refl = specular_bounce & ~is_spec_trans & active
            diff = tuple(
                jnp.where(
                    spec_refl[:, None],
                    refl_diff[k],
                    jnp.where(
                        (is_spec_trans & active)[:, None], trans_diff[k], dead[k]
                    ),
                )
                for k in range(4)
            )

        # BSSRDF branch (path.rs:166-210): specular-transmission bounces
        # into a subsurface material re-emerge at a profile-sampled exit
        # point with the Sw adapter BSDF.
        import numpy as np

        if bool(np.any(np.asarray(ctx.mats["has_bssrdf"]))):
            from ..bsdf import bssrdf as bss
            from ..lights.lights import is_delta as _is_delta, sample_li as _sample_li
            from .common import shadow_unoccluded

            is_trans = (
                ((bs.sampled_flags & BXDF_TRANSMISSION) != 0)
                & active
                & ctx.mats["has_bssrdf"][jnp.maximum(si.mat, 0)]
            )
            u1 = sampler.get_1d(pixel_id, s_idx, dim0 + sdims.PATH_BSS_PROBE_1D)
            u2 = sampler.get_2d(pixel_id, s_idx, dim0 + sdims.PATH_BSS_PROBE_2D)
            si_b = si._replace(valid=is_trans)
            bsample = bss.sample_bssrdf(ctx, si_b, frame, u1, u2)
            got = is_trans & bsample.valid
            beta = jnp.where(
                got[:, None],
                beta * bsample.sp / jnp.maximum(bsample.pdf, 1e-20)[:, None],
                beta,
            )
            active = jnp.where(is_trans, got, active)
            eta_b = ctx.mats["bssrdf_eta"][jnp.maximum(si.mat, 0)]

            # direct subsurface component: one-light NEE with Sw adapter
            if ctx.n_lights:
                u_pick = sampler.get_1d(pixel_id, s_idx, dim0 + sdims.PATH_BSS_PICK)
                lidx = jnp.minimum(
                    (u_pick * ctx.n_lights).astype(jnp.int32), ctx.n_lights - 1
                )
                u_l = sampler.get_2d(pixel_id, s_idx, dim0 + sdims.PATH_BSS_LIGHT)
                ls = _sample_li(ctx.lights, ctx.infinite_envs, lidx, bsample.pi.p, u_l)
                cos_wi = vec.dot(ls.wi, bsample.pi.ns)
                f_sw = bss.sw_f(eta_b, cos_wi)[:, None] * jnp.abs(cos_wi)[:, None]
                unocc = shadow_unoccluded(ctx, bsample.pi, ls.p_light)
                nee_ok = got & unocc & (ls.pdf > 0.0)
                L = L + jnp.where(
                    nee_ok[:, None],
                    beta * ls.li * f_sw * (float(ctx.n_lights) / jnp.maximum(ls.pdf, 1e-20))[:, None],
                    0.0,
                )

            # indirect: cosine-sample the Sw adapter at the exit point
            u_out = sampler.get_2d(pixel_id, s_idx, dim0 + sdims.PATH_BSS_OUT)
            from ..core.sampling import cosine_sample_hemisphere

            w_loc = cosine_sample_hemisphere(u_out)
            a1, a2 = vec.coordinate_system(bsample.pi.ns)
            w_out = (
                a1 * w_loc[:, 0:1] + a2 * w_loc[:, 1:2] + bsample.pi.ns * w_loc[:, 2:3]
            )
            cos_o = jnp.maximum(w_loc[:, 2], 1e-9)
            # f * cos / pdf with pdf = cos/pi -> Sw * pi
            beta = jnp.where(
                got[:, None], beta * (bss.sw_f(eta_b, cos_o) * PI)[:, None], beta
            )
            ro = jnp.where(
                got[:, None],
                geom.offset_ray_origin(bsample.pi.p, bsample.pi.ng, w_out),
                ro,
            )
            rd = jnp.where(got[:, None], w_out, rd)
            specular_bounce = jnp.where(got, False, specular_bounce)

        # Russian roulette (path.rs:212-222)
        rr_beta_max = jnp.max(beta * eta_scale[:, None], axis=-1)
        do_rr = active & (rr_beta_max < spec.rr_threshold) & (bounces > 3)
        q = jnp.maximum(0.05, 1.0 - rr_beta_max)
        u_rr = sampler.get_1d(pixel_id, s_idx, dim0 + sdims.PATH_RR)
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        beta = jnp.where(
            (do_rr & ~killed)[:, None], beta / jnp.maximum(1.0 - q, 1e-9)[:, None], beta
        )

    return L
