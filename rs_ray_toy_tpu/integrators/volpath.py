"""Volumetric path tracer (integrator/volpath.rs).

Wavefront form of the volpath bounce loop (volpath.rs:48-258): each
iteration intersects, samples the current medium over the segment, then
branches per-ray into a medium-interaction path (phase-function NEE +
HG direction sample) or the surface path (NEE + BSDF sample), with the
power-weighted light distribution (volpath.rs preprocess) and the same
etaScale Russian roulette as path.rs.

Medium transitions: rays carry a medium id updated at surface crossings
from the hit primitive's interface.  (The reference's is_medium_transition
is inverted (primitives.rs:104-112) so its per-primitive interfaces never
take effect and rays keep their birth medium; we implement the
PBRT-intended transition — docs/PARITY.md.)
"""

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE
from ..core import rng as rngmod
from ..core import vec
from ..core.sampling import Distribution1D, power_heuristic
from ..accel import geometry as geom
from ..core.tableops import take_rows
from ..bsdf import eval as beval
from ..bsdf.lobes import BXDF_ALL, BXDF_SPECULAR, BXDF_TRANSMISSION
from ..lights import lights as lmod
from ..scene import medium as med
from .common import SceneCtx, shadow_unoccluded


def _light_distribution(ctx: SceneCtx):
    """Power-weighted light distribution
    (compute_light_power_distribution, integrator/mod.rs:560-571).
    Built eagerly once per scene (cached on ctx) — light power is static."""
    return ctx._power_distribution


def _estimate_direct_volumetric(
    ctx, p, is_medium, si, params, frame, wo, g_med, light_idx, u_light,
    u_scatter, rng_state, valid, med_id=None,
):
    """estimate_direct with handle_media=true (integrator/mod.rs:403-558):
    phase function instead of BSDF at medium vertices, and transmittance-
    aware visibility (VisibilityTester::tr, lights/mod.rs:66-100 — without
    the reference's unreachable opaque-surface re-loop: one segment + tr)."""
    ls = lmod.sample_li(ctx.lights, ctx.infinite_envs, light_idx, p, u_light)

    # scattering value toward the light
    f_surf = beval.bsdf_f(
        params, frame, wo, ls.wi, BXDF_ALL & ~BXDF_SPECULAR
    ) * vec.absdot(ls.wi, frame.ns)[..., None]
    pdf_surf = beval.bsdf_pdf(params, frame, wo, ls.wi, BXDF_ALL & ~BXDF_SPECULAR)
    p_phase = med.phase_hg(vec.dot(wo, ls.wi), g_med)
    f = jnp.where(is_medium[..., None], p_phase[..., None], f_surf)
    scattering_pdf = jnp.where(is_medium, p_phase, pdf_surf)

    live = valid & (ls.pdf > 0.0) & jnp.any(ls.li > 0.0, axis=-1) & jnp.any(
        f > 0.0, axis=-1
    )
    # visibility with transmittance: offset from surfaces only
    origin = jnp.where(
        is_medium[..., None], p, geom.offset_ray_origin(p, si.ng, ls.p_light - p)
    )
    delta_vec = ls.p_light - origin
    seg_len = vec.length(delta_vec)
    d_unit = delta_vec / jnp.maximum(seg_len, 1e-20)[..., None]
    t_max = jnp.where(live, 1.0 - 1e-4, 0.0).astype(DTYPE) * seg_len
    occluded = ctx.occluded(origin, d_unit, t_max)
    tr = jnp.ones_like(f)
    if ctx.mediums is not None and ctx.mediums["n"] > 0 and med_id is not None:
        # transmittance through the current medium along the segment
        tr, rng_state = med.medium_tr(
            ctx.mediums, med_id, origin, d_unit, seg_len, rng_state
        )
    li = jnp.where((live & ~occluded)[..., None], ls.li * tr, 0.0)
    delta = lmod.is_delta(take_rows(ctx.lights.kind, light_idx))
    weight = jnp.where(delta, 1.0, power_heuristic(1, ls.pdf, 1, scattering_pdf))
    ld = li * f * (weight / jnp.maximum(ls.pdf, 1e-20))[..., None]
    ld = jnp.where(valid[..., None], ld, 0.0)

    # --- scattering-sampling branch (integrator/mod.rs:483-558) ---
    # Phase fn sampled at medium vertices, BSDF at surfaces; transmittance
    # walked along the sampled ray (intersect_tr, scene.rs:36-61).  Hits
    # never identify the sampled area light (the aggregate carries no
    # emissive prims, renderprocess.rs:1192 — common.estimate_direct
    # docstring), so radiance flows only from infinite lights on escape.
    import numpy as np

    kinds = np.asarray(ctx.lights.kind)
    if kinds.size and np.any((kinds != 0) & (kinds != 1)):
        non_delta = ~delta
        wi_med, p_med = med.hg_sample(wo, g_med, u_scatter)
        bs = beval.bsdf_sample(
            params, frame, wo, u_scatter, BXDF_ALL & ~BXDF_SPECULAR
        )
        f2_surf = bs.f * vec.absdot(bs.wi_world, frame.ns)[..., None]
        wi2 = jnp.where(is_medium[..., None], wi_med, bs.wi_world)
        f2 = jnp.where(is_medium[..., None], p_med[..., None], f2_surf)
        spdf2 = jnp.where(is_medium, p_med, bs.pdf)
        sampled_spec = ~is_medium & ((bs.sampled_flags & BXDF_SPECULAR) != 0)
        light_pdf2 = lmod.pdf_li(ctx.lights, ctx.infinite_envs, light_idx, p, wi2)
        w2 = jnp.where(sampled_spec, 1.0, power_heuristic(1, spdf2, 1, light_pdf2))
        live2 = (
            valid
            & non_delta
            & (is_medium | bs.valid)
            & jnp.any(f2 > 0.0, axis=-1)
            & (spdf2 > 0.0)
            & (sampled_spec | (light_pdf2 > 0.0))
        )
        origin2 = jnp.where(
            is_medium[..., None], p, geom.offset_ray_origin(p, si.ng, wi2)
        )
        big = jnp.where(live2, jnp.inf, 0.0).astype(DTYPE)
        hit2 = ctx.intersect(origin2, wi2, big)
        tr2 = jnp.ones_like(f2)
        if ctx.mediums is not None and ctx.mediums["n"] > 0 and med_id is not None:
            # escape keeps t_max = inf in the reference, so homogeneous tr
            # over the escape segment is exp(-sigma_t*MAX_FLT) = 0
            # (homogeneous.rs:34-36); grid tr is bounded by its box.  A
            # huge finite segment reproduces both without inf*0 NaNs.
            seg2 = jnp.where(hit2.valid, hit2.t, 1e8)
            tr2, rng_state = med.medium_tr(
                ctx.mediums, med_id, origin2, wi2, seg2, rng_state
            )
        li2 = jnp.zeros_like(f2)
        lkind = take_rows(ctx.lights.kind, light_idx)
        for env_id, env in enumerate(ctx.infinite_envs):
            if not bool(np.any(np.asarray(ctx.lights.shape_index) == env_id)):
                continue
            sel = (
                (lkind == lmod.LIGHT_INFINITE)
                & (take_rows(ctx.lights.shape_index, light_idx) == env_id)
                & ~hit2.valid
            )
            li2 = jnp.where(sel[..., None], lmod._env_lookup(env, wi2), li2)
        ld = ld + jnp.where(
            live2[..., None],
            li2 * f2 * tr2 * (w2 / jnp.maximum(spdf2, 1e-20))[..., None],
            0.0,
        )
    return ld, rng_state


def li_volpath(ctx: SceneCtx, o, d, cam_weight, sampler, pixel_id, s_idx, spec, camera_medium=-1):
    n = o.shape[0]
    C = ctx.n_channels
    L = jnp.zeros((n, C), DTYPE)
    beta = jnp.ones((n, C), DTYPE) * (cam_weight > 0.0)[:, None]
    active = cam_weight > 0.0
    specular_bounce = jnp.zeros((n,), bool)
    eta_scale = jnp.ones((n,), DTYPE)
    ro, rd = o, d
    med_id = jnp.full((n,), camera_medium, jnp.int32)
    light_pdfs = _light_distribution(ctx)
    rng_state = rngmod.hash_combine(pixel_id, s_idx.astype(jnp.uint32))

    from ..sampler import dims as sdims

    for bounces in range(spec.max_depth + 1):
        dim0 = sdims.volpath_dim0(bounces)
        t_max = jnp.where(active, jnp.inf, 0.0).astype(DTYPE)
        hit = ctx.intersect(ro, rd, t_max)
        si = ctx.surface(hit, ro, rd)
        found = hit.valid & active

        # ---- medium sampling over the segment (volpath.rs:70-85) ----
        seg_len = jnp.where(found, hit.t, 2.0 * ctx.lights.world_radius + 1000.0)
        if ctx.mediums is not None and ctx.mediums["n"] > 0:
            beta_med, in_medium, t_med, rng_state = med.medium_sample(
                ctx.mediums, jnp.where(active, med_id, -1), ro, rd, seg_len, rng_state
            )
            beta = beta * jnp.where(active[..., None], beta_med, 1.0)
        else:
            in_medium = jnp.zeros((n,), bool)
            t_med = seg_len
        p_vertex = jnp.where(in_medium[..., None], ro + rd * t_med[..., None], si.p)
        active = active & jnp.any(beta > 0.0, axis=-1)

        # emitted light (volpath.rs:88-99): surface le always 0; escapes
        # collect infinite le (not through a medium vertex)
        if ctx.infinite_envs:
            from ..lights.lights import le_escape

            collect = active & ~found & ~in_medium
            if bounces > 0:
                collect = collect & specular_bounce
            L = L + jnp.where(collect[:, None], beta * le_escape(ctx.infinite_envs, rd), 0.0)

        active = active & (found | in_medium) & (bounces < spec.max_depth)
        if bounces == spec.max_depth:
            break

        surf_valid = active & ~in_medium & found
        si = si._replace(valid=surf_valid)
        params = ctx.shade_params(si)
        frame = ctx.frame(si)
        wo = -rd
        g_med = ctx.mediums["g"][jnp.maximum(med_id, 0)] if (
            ctx.mediums is not None and ctx.mediums["n"] > 0
        ) else jnp.zeros((n,), DTYPE)

        # ---- NEE (volpath.rs:101-127) with power distribution ----
        from ..core.sampling import sample_discrete_1d

        u_pick = sampler.get_1d(pixel_id, s_idx, dim0)
        if light_pdfs is not None:
            light_idx, pick_pdf = sample_discrete_1d(light_pdfs, u_pick)
        else:
            light_idx = jnp.zeros((n,), jnp.int32)
            pick_pdf = jnp.ones((n,), DTYPE)
        u_light = sampler.get_2d(pixel_id, s_idx, dim0 + 1)
        u_scatter = sampler.get_2d(pixel_id, s_idx, dim0 + 2)
        n_nonspec = beval.num_components(params, BXDF_ALL & ~BXDF_SPECULAR)
        nee_valid = active & (in_medium | (surf_valid & (n_nonspec > 0)))
        ld, rng_state = _estimate_direct_volumetric(
            ctx, p_vertex, in_medium, si, params, frame, wo, g_med,
            light_idx, u_light, u_scatter, rng_state, nee_valid,
            med_id=med_id,
        )
        L = L + beta * ld / jnp.maximum(pick_pdf, 1e-20)[..., None]

        # ---- next direction ----
        u_next = sampler.get_2d(pixel_id, s_idx, dim0 + 3)
        # medium: HG sample (volpath.rs:137-147)
        wi_med, _ = med.hg_sample(wo, g_med, u_next)
        # surface: BSDF sample (volpath.rs:160-196)
        bs = beval.bsdf_sample(params, frame, wo, u_next, BXDF_ALL)
        ok_surf = surf_valid & bs.valid & jnp.any(bs.f != 0.0, axis=-1) & (bs.pdf > 0.0)
        beta_surf = (
            beta
            * bs.f
            * (vec.absdot(bs.wi_world, frame.ns) / jnp.maximum(bs.pdf, 1e-20))[:, None]
        )
        new_dir = jnp.where(in_medium[..., None], wi_med, bs.wi_world)
        beta = jnp.where(
            in_medium[..., None], beta, jnp.where(ok_surf[..., None], beta_surf, beta)
        )
        active = active & (in_medium | ok_surf)
        specular_bounce = jnp.where(
            in_medium, False, (bs.sampled_flags & BXDF_SPECULAR) != 0
        )

        # etaScale (volpath.rs:180-194)
        is_spec_trans = (
            ((bs.sampled_flags & BXDF_SPECULAR) != 0)
            & ((bs.sampled_flags & BXDF_TRANSMISSION) != 0)
            & ~in_medium
        )
        eta = params["eta"]
        entering = vec.dot(wo, si.ng) > 0.0
        eta_fac = jnp.where(entering, eta * eta, 1.0 / jnp.maximum(eta * eta, 1e-20))
        eta_scale = jnp.where(active & is_spec_trans, eta_scale * eta_fac, eta_scale)

        # medium transition at surface crossings (PBRT-intended)
        crossing = surf_valid & (vec.dot(new_dir, si.ng) < 0.0)
        tri_in = ctx.tri.med_in[jnp.clip(hit.index, 0, max(int(ctx.tri.count) - 1, 0))] if int(ctx.tri.count) else jnp.full((n,), -1, jnp.int32)
        tri_out = ctx.tri.med_out[jnp.clip(hit.index, 0, max(int(ctx.tri.count) - 1, 0))] if int(ctx.tri.count) else jnp.full((n,), -1, jnp.int32)
        sph_in = ctx.sph.med_in[jnp.clip(hit.index, 0, max(int(ctx.sph.count) - 1, 0))] if int(ctx.sph.count) else jnp.full((n,), -1, jnp.int32)
        sph_out = ctx.sph.med_out[jnp.clip(hit.index, 0, max(int(ctx.sph.count) - 1, 0))] if int(ctx.sph.count) else jnp.full((n,), -1, jnp.int32)
        m_in = jnp.where(hit.kind == geom.PRIM_SPHERE, sph_in, tri_in)
        m_out = jnp.where(hit.kind == geom.PRIM_SPHERE, sph_out, tri_out)
        has_interface = (m_in >= 0) | (m_out >= 0)
        med_id = jnp.where(
            surf_valid & has_interface, jnp.where(crossing, m_in, m_out), med_id
        )

        ro = jnp.where(
            active[:, None],
            jnp.where(
                in_medium[..., None],
                p_vertex,
                geom.offset_ray_origin(si.p, si.ng, new_dir),
            ),
            ro,
        )
        rd = jnp.where(active[:, None], new_dir, rd)

        # RR (volpath.rs:238-250)
        rr_beta_max = jnp.max(beta * eta_scale[:, None], axis=-1)
        do_rr = active & (rr_beta_max < spec.rr_threshold) & (bounces > 3)
        q = jnp.maximum(0.05, 1.0 - rr_beta_max)
        u_rr = sampler.get_1d(pixel_id, s_idx, dim0 + 4)
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        beta = jnp.where(
            (do_rr & ~killed)[:, None], beta / jnp.maximum(1.0 - q, 1e-9)[:, None], beta
        )

    return L
