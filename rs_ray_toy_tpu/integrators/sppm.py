"""Stochastic progressive photon mapping (integrator/sppm.rs).

Per iteration (sppm.rs:105-555):
  1. camera pass: one ray per pixel (Halton, sample_at_center, sample
     number = iteration) walked to the first diffuse vertex (or last-depth
     glossy) -> visible point {p, wo, beta, material}; direct lighting
     accumulates into pixel.ld.
  2. grid build over VP radii: the reference's hashed mutex linked lists
     (sppm.rs:267-344) become sort-by-cell + searchsorted ranges — each VP
     emits its (<=27) overlapping-cell hash entries, sorted once.
  3. photon pass: light by power distribution, path dims from pure
     radical_inverse(dim, halton_index) (sppm.rs:346-506); photons past
     depth 0 deposit beta*f(vp.wo, wi) into nearby VPs via the sorted grid
     (exact scan: the fori bound is the max cell occupancy) with
     scatter-add.
  4. per-pixel radius/tau update with gamma = 2/3.  (The reference drops
     PBRT's sqrt in r_new = r*sqrt(n_new/(n+m)), sppm.rs:508-532 — we
     use the PBRT-intended sqrt; docs/PARITY.md.)
  5. L = ld/(iter+1) + tau/(np * pi * r^2) into the film.

Visible points store (mat, uv, frame, p, wo, beta) and re-gather their
lobe rows for photon f() — equivalent to the reference cloning the Bsdf.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import DTYPE, PI
from ..core import vec
from ..core import lowdiscrepancy as ld
from ..core.sampling import sample_discrete_1d, uniform_sample_sphere
from ..accel import geometry as geom
from ..core.tableops import take_rows
from ..core.transform import apply_normal_jnp, apply_point_jnp
from ..bsdf import eval as beval
from ..bsdf.lobes import (
    BXDF_ALL,
    BXDF_DIFFUSE,
    BXDF_GLOSSY,
    BXDF_REFLECTION,
    BXDF_SPECULAR,
    BXDF_TRANSMISSION,
)
from ..core.spectrum import lum_any as luminance
from ..lights import lights as lmod
from .common import SceneCtx, uniform_sample_one_light

# replicate lights/point.rs sample_le's pdf_dir = 1/(2*pi) (PBRT intends
# the sphere pdf 1/(4*pi)); flips photon brightness by 2x
POINT_LE_PDF_QUIRK = True


class SPPMState(NamedTuple):
    radius: jnp.ndarray  # (P,)
    ld: jnp.ndarray  # (P,3)
    n: jnp.ndarray  # (P,)
    tau: jnp.ndarray  # (P,3)


class VisiblePoints(NamedTuple):
    p: jnp.ndarray  # (P,3)
    wo: jnp.ndarray  # (P,3)
    beta: jnp.ndarray  # (P,3)
    mat: jnp.ndarray  # (P,)
    uv: jnp.ndarray  # (P,2)
    ns: jnp.ndarray  # (P,3)
    ng: jnp.ndarray  # (P,3)
    dpdu: jnp.ndarray  # (P,3)
    valid: jnp.ndarray  # (P,)


def _camera_pass(ctx, cam, sampler, pixel_xy, pixel_id, it, max_depth, state):
    """(sppm.rs:140-260) -> (ld_delta (P,C), VisiblePoints)."""
    n = pixel_id.shape[0]
    C = getattr(ctx, "n_channels", 3)
    s_idx = jnp.full((n,), it, jnp.uint32)
    u_film = sampler.get_2d(pixel_id, s_idx, 0)  # centered when configured
    u_lens = sampler.get_2d(pixel_id, s_idx, 1)
    p_film = pixel_xy + u_film
    ro, rd, weight = cam.generate_rays(p_film, u_lens)
    beta = jnp.ones((n, C), DTYPE) * weight[:, None]
    active = weight > 0.0
    specular_bounce = jnp.zeros((n,), bool)

    ld_total = jnp.zeros((n, C), DTYPE)
    vp = VisiblePoints(
        p=jnp.zeros((n, 3), DTYPE),
        wo=jnp.zeros((n, 3), DTYPE),
        beta=jnp.zeros((n, C), DTYPE),
        mat=jnp.zeros((n,), jnp.int32),
        uv=jnp.zeros((n, 2), DTYPE),
        ns=jnp.zeros((n, 3), DTYPE),
        ng=jnp.zeros((n, 3), DTYPE),
        dpdu=jnp.zeros((n, 3), DTYPE),
        valid=jnp.zeros((n,), bool),
    )

    from ..sampler import dims as sdims

    for depth in range(max_depth):
        dim0 = sdims.sppm_dim0(depth)
        t_max = jnp.full((n,), jnp.inf, DTYPE)
        hit = ctx.intersect(ro, rd, t_max)
        found = hit.valid & active
        # escaped: infinite-light le over scene.lights (sppm.rs:178-183)
        if ctx.infinite_envs:
            esc = active & ~found
            env_le = jnp.zeros((n, C), DTYPE)
            for env_id, env in enumerate(ctx.infinite_envs):
                if bool(np.any(np.asarray(ctx.lights.shape_index) == env_id)):
                    env_le = env_le + lmod._env_lookup(env, rd)
            ld_total = ld_total + jnp.where(esc[:, None], beta * env_le, 0.0)
        active = active & found
        si = ctx.surface(hit, ro, rd)
        si = si._replace(valid=si.valid & active)
        params = ctx.shade_params(si)
        frame = ctx.frame(si)

        # direct lighting at the vertex (uniform one-light, no distrib)
        s_l, _ = uniform_sample_one_light(
            ctx, si, params, frame, sampler, pixel_id, s_idx, dim0
        )
        ld_total = ld_total + beta * s_l

        is_diffuse = (
            beval.num_components(
                params, BXDF_DIFFUSE | BXDF_REFLECTION | BXDF_TRANSMISSION
            )
            > 0
        )
        is_glossy = (
            beval.num_components(
                params, BXDF_GLOSSY | BXDF_REFLECTION | BXDF_TRANSMISSION
            )
            > 0
        )
        make_vp = active & (is_diffuse | (is_glossy & (depth == max_depth - 1)))
        vp = VisiblePoints(
            p=jnp.where(make_vp[:, None], si.p, vp.p),
            wo=jnp.where(make_vp[:, None], si.wo, vp.wo),
            beta=jnp.where(make_vp[:, None], beta, vp.beta),
            mat=jnp.where(make_vp, jnp.maximum(si.mat, 0), vp.mat),
            uv=jnp.where(make_vp[:, None], si.uv, vp.uv),
            ns=jnp.where(make_vp[:, None], si.ns, vp.ns),
            ng=jnp.where(make_vp[:, None], si.ng, vp.ng),
            dpdu=jnp.where(make_vp[:, None], si.dpdu, vp.dpdu),
            valid=vp.valid | make_vp,
        )
        active = active & ~make_vp
        if depth >= max_depth - 1:
            break

        u = sampler.get_2d(pixel_id, s_idx, dim0 + 5)
        bs = beval.bsdf_sample(params, frame, si.wo, u, BXDF_ALL)
        ok = active & bs.valid & jnp.any(bs.f != 0.0, axis=-1) & (bs.pdf > 0.0)
        specular_bounce = (bs.sampled_flags & BXDF_SPECULAR) != 0
        beta_new = (
            beta * bs.f * (vec.absdot(bs.wi_world, frame.ns) / jnp.maximum(bs.pdf, 1e-20))[:, None]
        )
        # camera-path RR (sppm.rs:247-253)
        y = luminance(beta_new)
        u_rr = sampler.get_1d(pixel_id, s_idx, dim0 + 6)
        rr = ok & (y < 0.25)
        cont_p = jnp.minimum(y, 1.0)
        killed = rr & (u_rr > cont_p)
        beta_new = jnp.where(
            rr[:, None], beta_new / jnp.maximum(cont_p, 1e-9)[:, None], beta_new
        )
        active = active & ok & ~killed
        beta = jnp.where(active[:, None], beta_new, beta)
        ro = jnp.where(active[:, None], geom.offset_ray_origin(si.p, si.ng, bs.wi_world), ro)
        rd = jnp.where(active[:, None], bs.wi_world, rd)

    return ld_total, vp


def _hash_cell(cx, cy, cz, hash_size):
    """(sppm.rs:100-103)"""
    h = (
        (cx * jnp.int32(73856093))
        ^ (cy * jnp.int32(19349663))
        ^ (cz * jnp.int32(83492791))
    )
    return jnp.abs(h) % hash_size


def _sample_le(ctx, light_idx, u0, u1):
    """Light::sample_le for point / distant / area lights (photon pass).

    Returns (o, d, n_light, le, pdf_pos, pdf_dir)."""
    lights = ctx.lights
    kind = take_rows(lights.kind, light_idx)
    emit = take_rows(lights.emit, light_idx)
    n = light_idx.shape[0]

    # point (lights/point.rs:87-113): uniform sphere, pdf_dir quirk
    d_pt = uniform_sample_sphere(u0)
    o_pt = take_rows(lights.p, light_idx)
    pdf_dir_pt = jnp.full((n,), 1.0 / (2.0 * PI) if POINT_LE_PDF_QUIRK else 1.0 / (4.0 * PI), DTYPE)

    # distant (lights/distant.rs sample_le): disk at world radius
    from ..core.sampling import concentric_sample_disk

    w = take_rows(lights.w_light, light_idx)
    v1, v2 = vec.coordinate_system(w)
    cd = concentric_sample_disk(u0)
    r = lights.world_radius
    p_disk = (
        lights.world_center
        + (v1 * cd[..., 0:1] + v2 * cd[..., 1:2]) * r
    )
    o_di = p_disk + w * r
    d_di = -w
    pdf_pos_di = jnp.full((n,), 1.0, DTYPE) / (PI * r * r)

    # area (lights/diffuse.rs sample_le): shape point + cosine hemisphere
    from ..core.sampling import cosine_sample_hemisphere

    sk = take_rows(lights.shape_kind, light_idx)
    o2w = take_rows(lights.sph_o2w, light_idx)
    w2o = take_rows(lights.sph_w2o, light_idx)
    radius_s = take_rows(lights.sph_radius, light_idx)
    p_obj = uniform_sample_sphere(u0) * radius_s[..., None]
    p_sph = apply_point_jnp(o2w, p_obj)
    n_sph = vec.normalize(apply_normal_jnp(w2o, p_obj))
    su = jnp.sqrt(jnp.maximum(u0[..., 0], 0.0))
    b0 = 1.0 - su
    b1 = u0[..., 1] * su
    tp = take_rows(lights.tri_p, light_idx)
    p_tri = (
        tp[:, 0] * b0[..., None]
        + tp[:, 1] * b1[..., None]
        + tp[:, 2] * (1.0 - b0 - b1)[..., None]
    )
    n_tri = vec.normalize(jnp.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]))
    is_tri = (sk == 1)[..., None]
    p_ar = jnp.where(is_tri, p_tri, p_sph)
    n_ar = jnp.where(is_tri, n_tri, n_sph)
    w_loc = cosine_sample_hemisphere(u1)
    a1, a2 = vec.coordinate_system(n_ar)
    d_ar = a1 * w_loc[..., 0:1] + a2 * w_loc[..., 1:2] + n_ar * w_loc[..., 2:3]
    pdf_pos_ar = 1.0 / jnp.maximum(take_rows(lights.area, light_idx), 1e-20)
    pdf_dir_ar = jnp.maximum(w_loc[..., 2], 0.0) / PI

    is_point = kind == 0
    is_dist = kind == 1
    is_area = kind == 2
    is_inf = kind == 3
    o = jnp.where(is_point[..., None], o_pt, jnp.where(is_dist[..., None], o_di, p_ar))
    d = jnp.where(is_point[..., None], d_pt, jnp.where(is_dist[..., None], d_di, d_ar))
    n_l = jnp.where(is_point[..., None], d_pt, jnp.where(is_dist[..., None], d_di, n_ar))
    le = emit
    # area lights emit only on the front side; cosine sample is front-only
    pdf_pos = jnp.where(is_point, 1.0, jnp.where(is_dist, pdf_pos_di, pdf_pos_ar))
    pdf_dir = jnp.where(
        is_point, pdf_dir_pt, jnp.where(is_dist, 1.0, pdf_dir_ar)
    )

    # infinite (lights/infinite.rs:207-256): direction from the 2D
    # luminance distribution; origin on a world-radius disk facing it
    if ctx.infinite_envs:
        import numpy as np

        from ..core.sampling import sample_continuous_2d
        from ..scene.mipmap import trilinear_lookup

        shape_idx = take_rows(lights.shape_index, light_idx)
        for env_id, env in enumerate(ctx.infinite_envs):
            if not bool(np.any(np.asarray(lights.shape_index) == env_id)):
                continue
            sel = is_inf & (shape_idx == env_id)
            uv, map_pdf = sample_continuous_2d(env["dist"], u0)
            theta = uv[..., 1] * PI
            phi = uv[..., 0] * 2.0 * PI
            sin_t = jnp.sin(theta)
            w_local = jnp.stack(
                [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)],
                axis=-1,
            )
            m = env["to_world"]
            d_inf = -jnp.matmul(w_local, m[:3, :3].T, precision="highest")
            v1i, v2i = vec.coordinate_system(-d_inf)
            cd_i = concentric_sample_disk(u1)  # ref uses the second uniform
            p_disk_i = (
                lights.world_center
                + (v1i * cd_i[..., 0:1] + v2i * cd_i[..., 1:2]) * r
            )
            o_inf = p_disk_i + (-d_inf) * r
            pdf_dir_inf = jnp.where(
                sin_t > 0.0,
                map_pdf / (2.0 * PI * PI * jnp.maximum(sin_t, 1e-9)),
                0.0,
            )
            le_inf = trilinear_lookup(env["mipmap"], uv)
            o = jnp.where(sel[..., None], o_inf, o)
            d = jnp.where(sel[..., None], d_inf, d)
            n_l = jnp.where(sel[..., None], d_inf, n_l)
            le = jnp.where(sel[..., None], le_inf, le)
            pdf_pos = jnp.where(sel, 1.0 / (PI * r * r), pdf_pos)
            pdf_dir = jnp.where(sel, pdf_dir_inf, pdf_dir)

    supported = is_point | is_dist | is_area | is_inf
    le = jnp.where(supported[..., None], le, 0.0)
    return o, d, n_l, le, pdf_pos, pdf_dir


def _emit_photons(ctx, light_distr, halton_index):
    """Photon emission: light pick by power distribution + sample_le,
    from pure radical_inverse over the global halton index
    (sppm.rs:355-366).  Returns (ro, rd, beta, active)."""
    n = halton_index.shape[0]

    def ri(dim):
        return ld.radical_inverse(dim, halton_index)

    u_light_sample = ri(0)
    light_idx, light_pdf = (
        sample_discrete_1d(light_distr, u_light_sample)
        if light_distr is not None
        else (jnp.zeros((n,), jnp.int32), jnp.ones((n,), DTYPE))
    )
    u0 = jnp.stack([ri(1), ri(2)], axis=-1)
    u1 = jnp.stack([ri(3), ri(4)], axis=-1)
    ro, rd, n_l, le, pdf_pos, pdf_dir = _sample_le(ctx, light_idx, u0, u1)
    beta = (
        le
        * vec.absdot(n_l, rd)[:, None]
        / jnp.maximum(light_pdf * pdf_pos * pdf_dir, 1e-20)[:, None]
    )
    ph_active = (
        (pdf_pos > 0.0) & (pdf_dir > 0.0) & jnp.any(le > 0.0, axis=-1)
        & jnp.any(beta > 0.0, axis=-1)
    )
    return ro, rd, beta, ph_active


def _radius_tau_update(state, vp, phi_acc, m_acc):
    """(sppm.rs:508-532, PBRT sqrt) — elementwise per pixel."""
    m = m_acc.astype(DTYPE)
    has_m = m_acc > 0
    gamma = 2.0 / 3.0
    n_new = state.n + gamma * m
    r_new = state.radius * jnp.sqrt(
        n_new / jnp.maximum(state.n + m, 1e-20)
    )
    tau_new = (
        (state.tau + vp.beta * phi_acc)
        * (r_new * r_new)[:, None]
        / jnp.maximum(state.radius * state.radius, 1e-20)[:, None]
    )
    return SPPMState(
        radius=jnp.where(has_m, r_new, state.radius),
        ld=state.ld,
        n=jnp.where(has_m, n_new, state.n),
        tau=jnp.where(has_m[:, None], tau_new, state.tau),
    )


def render_sppm(ctx: SceneCtx, cam, sampler, film_spec, spec, write_image_fn=None,
                time_stats=None, mesh=None):
    """Run SPPM; returns final (H,W,C) radiance image (C = 3 or 60 in
    sampled-spectral mode; the driver converts at the film).

    time_stats: optional dict; when given, one zero-iteration warm-up
    runs first (compiling the jitted iteration) and
    `time_stats["steady_s"]` records the wall-clock of the n_iters timed
    iterations only, so compilation does not fold into Mrays/s.

    mesh: SPPM renders on one device.  A mesh of more than one device
    raises NotImplementedError rather than quietly rendering on one."""
    if mesh is not None and int(mesh.devices.size) > 1:
        raise NotImplementedError(
            "SPPM renders on a single device; a mesh of "
            f"{int(mesh.devices.size)} devices is not supported"
        )
    h, w = film_spec.yres, film_spec.xres
    C = getattr(ctx, "n_channels", 3)
    n_pixels = h * w

    ys, xs = np.mgrid[0:h, 0:w]
    xs, ys = xs.ravel(), ys.ravel()
    pixel_xy = jnp.asarray(np.stack([xs, ys], -1), DTYPE)
    pixel_id = jnp.asarray(ys * w + xs, jnp.uint32)
    hash_size = n_pixels

    state = SPPMState(
        radius=jnp.full((n_pixels,), spec.radius, DTYPE),
        ld=jnp.zeros((n_pixels, C), DTYPE),
        n=jnp.zeros((n_pixels,), DTYPE),
        tau=jnp.zeros((n_pixels, C), DTYPE),
    )
    light_distr = ctx._power_distribution
    n_photons = spec.photons_per_iter

    def one_iteration(state, it):
        ld_delta, vp = _camera_pass(
            ctx, cam, sampler, pixel_xy, pixel_id, it, spec.max_depth, state,
        )
        state = state._replace(ld=state.ld + ld_delta)

        # ---- grid bounds / resolution (sppm.rs:262-292) ----
        valid = vp.valid & jnp.any(vp.beta > 0.0, axis=-1)
        big = jnp.float32(3e38)
        lo = jnp.min(
            jnp.where(valid[:, None], vp.p - state.radius[:, None], big), axis=0
        )
        hi = jnp.max(
            jnp.where(valid[:, None], vp.p + state.radius[:, None], -big), axis=0
        )
        any_vp = jnp.any(valid)
        lo = jnp.where(any_vp, lo, 0.0)
        hi = jnp.where(any_vp, hi, 1.0)
        diag = hi - lo
        max_diag = jnp.max(diag)
        max_radius = jnp.max(jnp.where(valid, state.radius, 0.0))
        base_res = max_diag / jnp.maximum(max_radius, 1e-20)
        grid_res = jnp.maximum(
            (base_res * diag / jnp.maximum(max_diag, 1e-20)).astype(jnp.int32), 1
        )

        def to_grid(p):
            rel = (p - lo) / jnp.where(diag == 0.0, 1.0, diag)
            c = (rel * grid_res.astype(DTYPE)).astype(jnp.int32)
            inb = jnp.all((c >= 0) & (c < grid_res), axis=-1)
            return jnp.clip(c, 0, grid_res - 1), inb

        # ---- VP -> cell entries (27 per VP, masked) ----
        cmin, _ = to_grid(vp.p - state.radius[:, None])
        cmax, _ = to_grid(vp.p + state.radius[:, None])
        entries_cell = []
        entries_vp = []
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    cx = cmin[:, 0] + dx
                    cy = cmin[:, 1] + dy
                    cz = cmin[:, 2] + dz
                    ok = (
                        valid
                        & (cx <= cmax[:, 0])
                        & (cy <= cmax[:, 1])
                        & (cz <= cmax[:, 2])
                    )
                    cell = jnp.where(ok, _hash_cell(cx, cy, cz, hash_size), hash_size)
                    entries_cell.append(cell)
                    entries_vp.append(jnp.arange(n_pixels, dtype=jnp.int32))
        cells = jnp.concatenate(entries_cell)
        vps = jnp.concatenate(entries_vp)
        order = jnp.argsort(cells)
        cells_sorted = cells[order]
        vps_sorted = vps[order]
        cell_start = jnp.searchsorted(cells_sorted, jnp.arange(hash_size))
        cell_end = jnp.searchsorted(cells_sorted, jnp.arange(hash_size), side="right")
        # exact per-cell scan length (traced fori bound -> while_loop):
        # the round-1 static 64-entry bound silently dropped deposits in
        # dense VP clusters — exactly where SPPM matters
        scan_len = jnp.max(cell_end - cell_start)

        # ---- photon pass (sppm.rs:346-506) ----
        pidx = jnp.arange(n_photons)
        halton_index = (it * n_photons + pidx).astype(jnp.int32)

        def ri(dim):
            return ld.radical_inverse(dim, halton_index)

        ro, rd, beta, ph_active = _emit_photons(ctx, light_distr, halton_index)

        phi_acc = jnp.zeros((n_pixels, C), DTYPE)
        m_acc = jnp.zeros((n_pixels,), jnp.int32)

        for depth in range(spec.max_depth):
            t_max = jnp.full((n_photons,), jnp.inf, DTYPE)
            hit = ctx.intersect(ro, rd, t_max)
            ph_active = ph_active & hit.valid
            si = ctx.surface(hit, ro, rd)
            si = si._replace(valid=si.valid & ph_active)

            if depth > 0:
                cell, inb = to_grid(si.p)
                hcell = _hash_cell(cell[:, 0], cell[:, 1], cell[:, 2], hash_size)
                start = cell_start[hcell]
                end = cell_end[hcell]
                deposit = ph_active & inb
                wi_ph = -rd

                def scan_body(k, carry):
                    phi_acc, m_acc = carry
                    slot = jnp.minimum(start + k, cells.shape[0] - 1)
                    vp_i = vps_sorted[slot]
                    live = deposit & (start + k < end)
                    # distance test against this VP
                    d2 = vec.length_squared(vp.p[vp_i] - si.p)
                    rad = state.radius[vp_i]
                    near = live & valid[vp_i] & (d2 <= rad * rad)
                    # f(vp.wo, wi) with the VP's material
                    vp_params = beval.gather_lobes(
                        ctx.mats, None, vp.mat[vp_i], static_kinds=ctx.static_kinds
                    )
                    vp_frame = beval.make_frame(
                        vp.ns[vp_i], vp.ng[vp_i], vp.dpdu[vp_i]
                    )
                    f = beval.bsdf_f(vp_params, vp_frame, vp.wo[vp_i], wi_ph, BXDF_ALL)
                    contrib = jnp.where(near[:, None], beta * f, 0.0)
                    phi_acc = phi_acc.at[vp_i].add(contrib)
                    m_acc = m_acc.at[vp_i].add(near.astype(jnp.int32))
                    return phi_acc, m_acc

                phi_acc, m_acc = lax.fori_loop(
                    0, scan_len, scan_body, (phi_acc, m_acc)
                )

            # next photon bounce (sppm.rs:455-505)
            params = ctx.shade_params(si)
            frame = ctx.frame(si)
            d_b = 5 + 2 * depth
            u_b = jnp.stack([ri(d_b), ri(d_b + 1)], axis=-1)
            bs = beval.bsdf_sample(params, frame, -rd, u_b, BXDF_ALL)
            ok = ph_active & bs.valid & jnp.any(bs.f != 0.0, axis=-1) & (bs.pdf > 0.0)
            bnew = (
                beta
                * bs.f
                * (vec.absdot(bs.wi_world, frame.ns) / jnp.maximum(bs.pdf, 1e-20))[:, None]
            )
            q = jnp.maximum(
                0.0, 1.0 - luminance(bnew) / jnp.maximum(luminance(beta), 1e-20)
            )
            u_rr = ri(d_b + 2 + spec.max_depth * 2)
            killed = u_rr < q
            ph_active = ok & ~killed
            beta = jnp.where(
                ph_active[:, None], bnew / jnp.maximum(1.0 - q, 1e-9)[:, None], beta
            )
            ro = jnp.where(
                ph_active[:, None],
                geom.offset_ray_origin(si.p, si.ng, bs.wi_world),
                ro,
            )
            rd = jnp.where(ph_active[:, None], bs.wi_world, rd)

        return _radius_tau_update(state, vp, phi_acc, m_acc)

    # ONE dispatch for all iterations between image writes: a fori_loop
    # over the iteration body, so no per-iteration host round trip
    @jax.jit
    def run_range(st, it0, it1):
        return lax.fori_loop(
            it0, it1,
            lambda i, s: one_iteration(s, i.astype(jnp.uint32)),
            st,
        )

    # AOT-compile + zero-iteration warm-up (program upload only), so the
    # timed region measures iteration throughput, not compilation
    compiled = run_range.lower(state, jnp.int32(0), jnp.int32(0)).compile()
    jax.block_until_ready(compiled(state, jnp.int32(0), jnp.int32(0)))
    if time_stats is not None:
        import time as _time

        t0 = _time.time()
    wf = spec.write_freq if write_image_fn is not None else spec.n_iters
    done = 0
    while done < spec.n_iters:
        nxt = min(done + max(1, wf), spec.n_iters)
        state = compiled(state, jnp.int32(done), jnp.int32(nxt))
        done = nxt
        if write_image_fn is not None:
            img = _sppm_image(state, done, n_photons, h, w)
            write_image_fn(img, done)
    if time_stats is not None:
        state = jax.block_until_ready(state)
        time_stats["steady_s"] = _time.time() - t0
    return _sppm_image(state, spec.n_iters, n_photons, h, w)


def _sppm_image(state, iters_done, n_photons, h, w):
    np_total = iters_done * n_photons
    l = state.ld / iters_done + state.tau / jnp.maximum(
        np_total * PI * state.radius[:, None] ** 2, 1e-20
    )
    return l.reshape(h, w, l.shape[-1])
