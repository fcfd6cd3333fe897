"""Shared integrator machinery (integrator/mod.rs free functions).

SceneCtx bundles the device tables and exposes closest-hit / any-hit /
shading entry points so integrators do not depend on the accelerator
(all-pairs intersection or BVH traversal).

estimate_direct mirrors integrator/mod.rs:403-558 in batched form: the
light-sampling branch with the delta/MIS split, and the BSDF-sampling
branch for non-delta lights.  Note the reference's aggregate never links
area lights into primitives (renderprocess.rs:1192 "we'll figure out
emissive primitive later"), so the "did the BSDF ray hit the sampled
light" identity check (integrator/mod.rs:540-547) can never pass; the
BSDF branch therefore only contributes for escaped rays hitting an
infinite light — replicated here.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..config import DTYPE, SHADOW_EPSILON
from ..core import vec
from ..core.sampling import power_heuristic
from ..accel import geometry as geom
from ..core.tableops import take_rows
from ..bsdf import eval as beval
from ..bsdf.lobes import BXDF_ALL, BXDF_SPECULAR
from ..lights import lights as lmod
from ..scene import textures as tex


class SceneCtx:
    """Host-side wrapper over SceneBundle device tables."""

    def __init__(self, bundle):
        import numpy as np

        self.b = bundle
        self.tri = bundle.triangles
        self.sph = bundle.spheres
        self.lights = bundle.lights
        self.mats = bundle.materials
        self.registry = bundle.registry
        self.dev_images = bundle.dev_images
        self.infinite_envs = bundle.infinite
        self.n_lights = int(self.lights.count)
        self.n_channels = getattr(bundle, "n_channels", 3)
        if bundle.mediums:
            from ..scene.medium import pack_mediums

            self.mediums = pack_mediums(
                bundle.mediums, n_channels=getattr(bundle, "n_channels", 3)
            )
        else:
            self.mediums = None
        self.camera_medium = bundle.camera_medium
        # power light distribution, built eagerly (outside any trace)
        if self.n_lights:
            from ..core.sampling import Distribution1D
            from ..lights import lights as _lm

            self._power_distribution = Distribution1D(
                np.asarray(_lm.power(self.lights))
            ).as_device()
        else:
            self._power_distribution = None
        # static facts about the material table (compile-time pruning)
        self.static_kinds = frozenset(np.unique(np.asarray(self.mats["kind"])))
        self.uses_textures = bool(
            max(
                (
                    int(np.max(np.asarray(self.mats[k])))
                    for k in (
                        "s0_tex",
                        "rough_u_tex",
                        "rough_v_tex",
                        "sigma_tex",
                        "scale_tex",
                        "disney_base_tex",
                    )
                ),
                default=-1,
            )
            >= 0
        )

        # accelerator choice: all-pairs intersection for small scenes, a
        # BVH above BRUTE_FORCE_CUTOFF primitives
        from ..accel.bvh import BRUTE_FORCE_CUTOFF, build_bvh

        n_prims = int(self.tri.count) + int(self.sph.count)
        self.bvh = (
            build_bvh(self.tri, self.sph, bundle.max_prims_in_node)
            if n_prims > BRUTE_FORCE_CUTOFF
            else None
        )
        # packed shading-attribute tables: one row-selection per hit batch
        self.shade_tables = geom.pack_shade_tables(self.tri, self.sph)

    def intersect(self, o, d, t_max):
        if self.bvh is not None:
            from ..accel.traverse import intersect_bvh

            return intersect_bvh(self.bvh, self.tri, self.sph, o, d, t_max)
        return geom.intersect_brute(self.tri, self.sph, o, d, t_max)

    def surface(self, hit, o, d):
        return geom.surface_interaction(
            self.tri, self.sph, hit, o, d, shade_tables=self.shade_tables
        )

    def occluded(self, o, d, t_max):
        if self.bvh is not None:
            from ..accel.traverse import occluded_bvh

            return occluded_bvh(self.bvh, self.tri, self.sph, o, d, t_max)
        return geom.occluded_brute(self.tri, self.sph, o, d, t_max)

    def shade_params(self, si: geom.SurfaceHit, duv=None):
        """Gather per-hit lobe params (texture-resolved; duv enables
        filtered texture lookups at primary hits)."""
        mat_id = jnp.maximum(si.mat, 0)
        tex_vals = (
            tex.eval_all(self.registry, self.dev_images, si.uv, si.p, duv)
            if (self.registry.records and self.uses_textures)
            else None
        )
        params = beval.gather_lobes(
            self.mats, tex_vals, mat_id, static_kinds=self.static_kinds
        )
        # dead hits get zero lobes
        dead = si.mat < 0
        params["kind"] = jnp.where(dead[:, None], 0, params["kind"])
        return params

    def frame(self, si: geom.SurfaceHit):
        si = self.apply_bump(si)
        return beval.make_frame(si.ns, si.ng, si.dpdu)

    def apply_bump(self, si: geom.SurfaceHit):
        """Bump mapping (material/mod.rs:22-62) via displacement-texture
        finite differences.  Camera paths here carry no ray differentials,
        so the reference's no-differential fallback offsets du = dv =
        0.0005 apply (material/mod.rs:31-40)."""
        import numpy as np

        bump_ids = np.asarray(self.mats["bump_tex"])
        if not (bump_ids >= 0).any() or not self.registry.records:
            return si
        mat_id = jnp.maximum(si.mat, 0)
        btex = self.mats["bump_tex"][mat_id]
        has = (btex >= 0) & si.valid
        du = dv = 5e-4
        tex0 = tex.eval_all(self.registry, self.dev_images, si.uv, si.p)
        texu = tex.eval_all(
            self.registry,
            self.dev_images,
            si.uv + jnp.asarray([du, 0.0], DTYPE),
            si.p + si.dpdu * du,
        )
        texv = tex.eval_all(
            self.registry,
            self.dev_images,
            si.uv + jnp.asarray([0.0, dv], DTYPE),
            si.p + si.dpdv * dv,
        )
        rows = jnp.arange(mat_id.shape[0])
        bsafe = jnp.maximum(btex, 0)
        disp = tex0[bsafe, rows, 0]
        disp_u = texu[bsafe, rows, 0]
        disp_v = texv[bsafe, rows, 0]
        dpdu2 = si.dpdu + ((disp_u - disp) / du)[:, None] * si.ns
        dpdv2 = si.dpdv + ((disp_v - disp) / dv)[:, None] * si.ns
        ns2 = vec.normalize(vec.cross(dpdu2, dpdv2))
        ns2 = vec.faceforward(ns2, si.ns)
        return si._replace(
            dpdu=jnp.where(has[:, None], dpdu2, si.dpdu),
            dpdv=jnp.where(has[:, None], dpdv2, si.dpdv),
            ns=jnp.where(has[:, None], ns2, si.ns),
        )


def shadow_unoccluded(ctx: SceneCtx, si: geom.SurfaceHit, p_light):
    """VisibilityTester::unoccluded (lights/mod.rs:63-65) via one any-hit
    batch: ray from offset p to offset target, t_max = 1 - SHADOW_EPSILON
    in parametric units (interaction.rs:66-75)."""
    origin = geom.offset_ray_origin(si.p, si.ng, p_light - si.p)
    d = p_light - origin
    # dead lanes carry t_max = 0 so traversal culls them
    t_max = jnp.where(si.valid, 1.0 - SHADOW_EPSILON, 0.0).astype(DTYPE)
    return ~ctx.occluded(origin, d, t_max)


def estimate_direct(ctx: SceneCtx, si, params, frame, light_idx, u_light, u_scatter):
    """One light's direct contribution at each shading point (no media).

    Returns (N,3).  bsdf_flags = ALL & ~SPECULAR (specular=false path,
    integrator/mod.rs:413-417).
    """
    flags = BXDF_ALL & ~BXDF_SPECULAR
    ls = lmod.sample_li(ctx.lights, ctx.infinite_envs, light_idx, si.p, u_light)
    ld = jnp.zeros_like(ls.li)

    # --- light-sampling branch ---
    f, scattering_pdf = beval.bsdf_f_pdf(params, frame, si.wo, ls.wi, flags)
    f = f * vec.absdot(ls.wi, frame.ns)[..., None]
    live = (
        si.valid
        & (ls.pdf > 0.0)
        & jnp.any(ls.li > 0.0, axis=-1)
        & jnp.any(f > 0.0, axis=-1)
    )
    unocc = shadow_unoccluded(ctx, si, ls.p_light)
    li = jnp.where((live & unocc)[..., None], ls.li, 0.0)
    delta = lmod.is_delta(take_rows(ctx.lights.kind, light_idx))
    weight = jnp.where(
        delta, 1.0, power_heuristic(1, ls.pdf, 1, scattering_pdf)
    )
    ld = ld + li * f * (weight / jnp.maximum(ls.pdf, 1e-20))[..., None]

    # --- BSDF-sampling branch (non-delta lights only) ---
    # static skip: if the light table holds only delta kinds, the branch is
    # dead (see module docstring re: area-light identity check).
    import numpy as np

    kinds = np.asarray(ctx.lights.kind)
    if kinds.size and np.any((kinds != 0) & (kinds != 1)):
        bs = beval.bsdf_sample(params, frame, si.wo, u_scatter, flags)
        f2 = bs.f * vec.absdot(bs.wi_world, frame.ns)[..., None]
        sampled_spec = (bs.sampled_flags & BXDF_SPECULAR) != 0
        light_pdf2 = lmod.pdf_li(
            ctx.lights, ctx.infinite_envs, light_idx, si.p, bs.wi_world
        )
        w2 = jnp.where(
            sampled_spec, 1.0, power_heuristic(1, bs.pdf, 1, light_pdf2)
        )
        live2 = (
            si.valid
            & bs.valid
            & jnp.any(f2 > 0.0, axis=-1)
            & (bs.pdf > 0.0)
            & (sampled_spec | (light_pdf2 > 0.0))
        )
        origin = geom.offset_ray_origin(si.p, si.ng, bs.wi_world)
        big = jnp.where(live2, jnp.inf, 0.0).astype(DTYPE)
        hit2 = ctx.intersect(origin, bs.wi_world, big)
        # hits never identify the sampled area light (aggregate carries no
        # emissive prims, see docstring); escaped rays collect the sampled
        # light's own le — nonzero only for infinite lights.
        li2 = jnp.zeros_like(f2)
        lkind = take_rows(ctx.lights.kind, light_idx)
        for env_id, env in enumerate(ctx.infinite_envs):
            sel = (
                (lkind == lmod.LIGHT_INFINITE)
                & (take_rows(ctx.lights.shape_index, light_idx) == env_id)
                & ~hit2.valid
            )
            if not bool(np.any(np.asarray(ctx.lights.shape_index) == env_id)):
                continue
            li2 = jnp.where(
                sel[..., None], lmod._env_lookup(env, bs.wi_world), li2
            )
        ld = ld + jnp.where(
            live2[..., None],
            li2 * f2 * (w2 / jnp.maximum(bs.pdf, 1e-20))[..., None],
            0.0,
        )
    return jnp.where(si.valid[..., None], ld, 0.0)


def uniform_sample_all_lights(ctx: SceneCtx, si, params, frame, sampler, pixel_id, s_idx, dim_base):
    """(integrator/mod.rs:304-355): every light estimated with its
    round_count(n_samples) sample array and averaged — the reference's
    requested 2D arrays become extra static sampler dimensions here."""
    import numpy as np

    total = jnp.zeros((si.p.shape[0], ctx.n_channels), DTYPE)
    dim = dim_base
    n_samples_tbl = np.asarray(ctx.lights.n_samples)
    for j in range(ctx.n_lights):
        ns = _round_up_pow2(int(n_samples_tbl[j]))
        idx = jnp.full(pixel_id.shape, j, jnp.int32)
        acc = jnp.zeros_like(total)
        for k in range(ns):
            u_light = sampler.get_2d(pixel_id, s_idx, dim)
            u_scatter = sampler.get_2d(pixel_id, s_idx, dim + 1)
            dim += 2
            acc = acc + estimate_direct(
                ctx, si, params, frame, idx, u_light, u_scatter
            )
        total = total + acc / ns
    return total, dim


def _round_up_pow2(n):
    """Sampler round_count (misc.rs round_up_pow2 via stratified.rs)."""
    p = 1
    while p < max(n, 1):
        p <<= 1
    return p


def uniform_sample_one_light(
    ctx: SceneCtx, si, params, frame, sampler, pixel_id, s_idx, dim_base, light_pdfs=None
):
    """(integrator/mod.rs:359-401): pick one light (uniform or by power
    distribution), estimate, divide by its pdf."""
    if ctx.n_lights == 0:
        return jnp.zeros((si.p.shape[0], ctx.n_channels), DTYPE), dim_base
    u_pick = sampler.get_1d(pixel_id, s_idx, dim_base)
    if light_pdfs is None:
        idx = jnp.minimum(
            (u_pick * ctx.n_lights).astype(jnp.int32), ctx.n_lights - 1
        )
        pdf = jnp.full(u_pick.shape, 1.0 / ctx.n_lights, DTYPE)
    else:
        from ..core.sampling import sample_discrete_1d

        idx, pdf = sample_discrete_1d(light_pdfs, u_pick)
    u_light = sampler.get_2d(pixel_id, s_idx, dim_base + 1)
    u_scatter = sampler.get_2d(pixel_id, s_idx, dim_base + 2)
    ld = estimate_direct(ctx, si, params, frame, idx, u_light, u_scatter)
    return ld / jnp.maximum(pdf, 1e-20)[..., None], dim_base + 3


def scrub_radiance(l):
    """NaN / negative / infinite luminance scrub
    (integrator/mod.rs:105-122) vectorized."""
    from ..core.spectrum import lum_any

    y = lum_any(l)
    bad = ~jnp.isfinite(y) | (y < -1e-5) | ~jnp.all(jnp.isfinite(l), axis=-1)
    return jnp.where(bad[..., None], 0.0, l)
