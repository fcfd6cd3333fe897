"""Batched BSDF evaluation/sampling/pdf over the lobe table.

Implements the reference's Bsdf methods (reflection.rs:252-404) as
data-parallel code over (N,) hit batches with a static unrolled loop over
the MAX_LOBES lobe slots.  Lobe kinds are resolved by masked select — every
kind's math is computed and the per-lobe kind picks — which is the
branch-free form that batches over hits.  (Material-sorted dispatch is a later perf
phase; the estimator here is what matters first.)

Estimator parity (SURVEY §7 hard part 3): `sample` mirrors
Bsdf::sample_f (reflection.rs:302-381) **including its quirks**:
- the returned f is the *chosen* lobe's sample_f value; the recomputed
  all-lobe f is discarded (shadowed binding, reflection.rs:369-379);
- other matching lobes' pdfs are added only when the chosen lobe is not
  reflective (reflection.rs:358-364), then pdf /= matching_comps.
These choices change the estimator, so pixel parity requires them; both are
flagged `REFERENCE_QUIRKS` below so a later PBRT-exact mode can flip them.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..config import DTYPE, PI, ONE_MINUS_EPSILON
from ..core import vec
from ..core.sampling import cosine_sample_hemisphere
from . import microfacet as mf
from .lobes import (
    DIST_DISNEY_SEPARABLE_G,
    FRESNEL_DISNEY,
    LOBE_DISNEY_CLEARCOAT,
    LOBE_DISNEY_DIFFUSE,
    LOBE_DISNEY_FAKE_SS,
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_DISNEY_RETRO,
    LOBE_DISNEY_SHEEN,
    BXDF_ALL,
    BXDF_REFLECTION,
    BXDF_SPECULAR,
    BXDF_TRANSMISSION,
    DIST_BECKMANN,
    FRESNEL_CONDUCTOR,
    FRESNEL_DIELECTRIC,
    FRESNEL_NOOP,
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_FRESNEL_BLEND,
    LOBE_FRESNEL_SPEC,
    LOBE_LAMBERT_REFL,
    LOBE_LAMBERT_TRANS,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
    LOBE_NONE,
    LOBE_OREN_NAYAR,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
    MAX_LOBES,
    DR_DIFFUSE,
    DR_DIFFUSE_THIN,
    DR_FAKE_SS,
    DR_RETRO,
    DR_SHEEN,
    DR_MF_REFL,
    DR_CLEARCOAT,
    DR_MF_TRANS,
    DR_MF_TRANS_THIN,
    DR_LAMBERT_TRANS,
)

REFERENCE_QUIRKS = True


class Frame(NamedTuple):
    """Shading frame (Bsdf::new, reflection.rs:216-227)."""

    ns: jnp.ndarray
    ng: jnp.ndarray
    ss: jnp.ndarray
    ts: jnp.ndarray


def make_frame(ns, ng, dpdu):
    ss = vec.normalize(dpdu)
    # guard: dpdu may be zero for degenerate hits
    bad = vec.length_squared(dpdu) < 1e-20
    fb1, _ = vec.coordinate_system(ns)
    ss = jnp.where(bad[..., None], fb1, ss)
    ts = vec.cross(ns, ss)
    return Frame(ns=ns, ng=ng, ss=ss, ts=ts)


def world_to_local(fr: Frame, v):
    return jnp.stack(
        [vec.dot(v, fr.ss), vec.dot(v, fr.ts), vec.dot(v, fr.ns)], axis=-1
    )


def local_to_world(fr: Frame, v):
    return (
        fr.ss * v[..., 0:1] + fr.ts * v[..., 1:2] + fr.ns * v[..., 2:3]
    )


# ---- Fresnel (reflection.rs:145-195) ----


def fr_dielectric(cos_i, eta_i, eta_t):
    cos_i = jnp.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(cos_i)
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - ci * ci))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-20)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-20)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, fr)


def fr_conductor(cos_i, eta, k):
    """cos_i: (N,), eta/k: (N,3) relative to eta_i=1."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - si2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-20)
    t3 = a2b2 * ci2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-20)
    return 0.5 * (rp + rs)


def _schlick_weight(cos_t):
    m = jnp.clip(1.0 - cos_t, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _fresnel_eval(params, cos_i):
    """Dispatch on fresnel code: returns (N,3)."""
    fr_d = fr_dielectric(cos_i, params["eta_a"], params["eta_b"])[..., None]
    # conductor uses |cos| (reflection.rs:611)
    fr_c = fr_conductor(cos_i, params["s2"], params["s1"])
    one = jnp.ones_like(fr_d)
    code = params["fresnel"][..., None]
    out = jnp.where(
        code == FRESNEL_DIELECTRIC,
        fr_d,
        jnp.where(code == FRESNEL_CONDUCTOR, fr_c, one),
    )
    if params.get("_kinds") is None or LOBE_DISNEY_MICROFACET_REFL in params["_kinds"]:
        # DisneyFresnel (disney.rs:310-333): lerp(metallic,
        # dielectric(1,eta), schlick(c_spec0)); metallic lives in eta_a,
        # eta in eta_b for this lobe kind
        metallic = params["eta_a"][..., None]
        fr_diel = fr_dielectric(cos_i, 1.0, params["eta_b"])[..., None]
        schlick = params["s1"] + (1.0 - params["s1"]) * _schlick_weight(cos_i)[..., None]
        fr_dis = (1.0 - metallic) * fr_diel + metallic * schlick
        out = jnp.where(code == FRESNEL_DISNEY, fr_dis, out)
    return out


# ---- local-frame helpers ----


def _same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def _abs_cos(w):
    return jnp.abs(w[..., 2])


# ---- lobe gathering ----


def gather_lobes(mats, tex_vals, mat_id, static_kinds=None):
    """Gather all lobe-slot tables for each hit: dict of (N, L, ...).

    tex_vals: (n_tex, N, 3) from textures.eval_all, or None.
    Resolves texture indirection for s0 / roughness / sigma / scale.
    """
    # two fused per-material row selections for all per-lobe tables
    # (core/tableops.take_rows)
    from ..core.tableops import take_rows

    C = int(mats.get("n_channels", 3))
    pf = take_rows(mats["packed_f"], mat_id)  # (N, L, 4C+4)
    pi_ = take_rows(mats["packed_i"], mat_id)  # (N, L, 12)
    import numpy as _np

    out = {
        "_kinds": static_kinds,
        "_C": C,
        # static fact: does any lobe use the Beckmann distribution?
        # (prunes the Beckmann wh sampler from the trace otherwise)
        "_has_beckmann": bool(_np.any(_np.asarray(mats["dist"]) == DIST_BECKMANN)),
        "kind": pi_[..., 0],
        "flags": pi_[..., 1],
        "s0": pf[..., 0:C],
        "s1": pf[..., C : 2 * C],
        "s2": pf[..., 2 * C : 3 * C],
        "fresnel": pi_[..., 2],
        "dist": pi_[..., 3],
        "sample_visible": pi_[..., 5] != 0,
        "scale": pf[..., 3 * C + 4 : 4 * C + 4],
        "n_lobes": take_rows(mats["n_lobes"], mat_id),
        "eta": take_rows(mats["eta"], mat_id),
    }
    fp = pf[..., 3 * C : 3 * C + 4]
    rough_u = fp[..., 0]
    rough_v = fp[..., 1]
    sigma = fp[..., 0]

    if tex_vals is not None and tex_vals.shape[0] > 0:
        n_tex = tex_vals.shape[0]

        def tex_gather(tex_id, lift=False):
            # select-chain over the (small) texture registry
            acc = jnp.zeros(tex_id.shape + (3,), tex_vals.dtype)
            for t in range(n_tex):
                acc = jnp.where(
                    (tex_id == t)[..., None], tex_vals[t][:, None, :], acc
                )
            if lift and C != 3:
                # spectral mode: texture RGB -> N channels per hit on
                # device (Spectrum::from_rgb Reflectance; linear einsum
                # against the Smits bases)
                from ..core import spectral as _sp

                acc = _sp.from_rgb(acc, _sp.REFLECTANCE)
            return acc  # (N,L,3|C)

        def tex_gather_f(tex_id):
            return tex_gather(tex_id)[..., 0]

        s0_tex = pi_[..., 6]
        out["s0"] = jnp.where(
            (s0_tex >= 0)[..., None], tex_gather(s0_tex, lift=True), out["s0"]
        )
        ru_tex = pi_[..., 7]
        rough_u = jnp.where(ru_tex >= 0, tex_gather_f(ru_tex), rough_u)
        rv_tex = pi_[..., 8]
        rough_v = jnp.where(rv_tex >= 0, tex_gather_f(rv_tex), rough_v)
        sg_tex = pi_[..., 9]
        sigma = jnp.where(sg_tex >= 0, jnp.clip(tex_gather_f(sg_tex), 0.0, 90.0), sigma)
        sc_tex = pi_[..., 10]
        sc = tex_gather(sc_tex, lift=True)
        sc = jnp.where((pi_[..., 11] != 0)[..., None], 1.0 - sc, sc)
        out["scale"] = jnp.where(
            (sc_tex >= 0)[..., None], jnp.clip(sc, 0.0, jnp.inf) * out["scale"], out["scale"]
        )

    # roughness remap (microfacet.rs:12) applied where flagged
    remap = pi_[..., 4] != 0
    rough_u = jnp.where(remap, mf.roughness_to_alpha(rough_u), rough_u)
    rough_v = jnp.where(remap, mf.roughness_to_alpha(rough_v), rough_v)
    out["alpha_u"] = rough_u
    out["alpha_v"] = rough_v
    out["sigma"] = sigma
    out["eta_a"] = fp[..., 2]
    out["eta_b"] = fp[..., 3]
    # spec lobes store eta in f0/f1
    out["spec_eta_a"] = fp[..., 0]
    out["spec_eta_b"] = fp[..., 1]

    import numpy as np

    if bool(np.any(np.asarray(mats["is_disney_tex"]))):
        _assemble_disney_textured(out, mats, tex_vals, mat_id)
    return out


def _assemble_disney_textured(out, mats, tex_vals, mat_id):
    """Per-hit Disney lobe assembly for textured parameters
    (disney.rs:530-676): base params are texture-evaluated at the hit,
    lobe weights/alphas recomputed, and the reference's per-hit gates
    (diffuse_weight>0, sheen>0, clearcoat>0, spec_trans>0) disable slots
    by setting kind = LOBE_NONE — identical to the reference not adding
    the BxDF.  tex_vals None (e.g. the SPPM photon pass) falls back to
    the constant base values."""
    from ..core.tableops import take_rows

    roles = take_rows(mats["disney_roles"], mat_id)  # (N, L)
    base = take_rows(mats["disney_base_const"], mat_id)  # (N, 13, 3)
    if tex_vals is not None and tex_vals.shape[0] > 0:
        btex = take_rows(mats["disney_base_tex"], mat_id)  # (N, 13)
        n_tex = tex_vals.shape[0]
        tv = jnp.zeros(btex.shape + (3,), base.dtype)
        for t in range(n_tex):
            tv = jnp.where((btex == t)[..., None], tex_vals[t][:, None, :], tv)
        base = jnp.where((btex >= 0)[..., None], tv, base)

    c = jnp.clip(base[:, 0, :], 0.0, jnp.inf)
    mw = base[:, 1, 0]
    e = base[:, 2, 0]
    rough = base[:, 3, 0]
    st = base[:, 4, 0]
    aniso = base[:, 5, 0]
    sheen_w = base[:, 6, 0]
    stint = base[:, 7, 0]
    cc = base[:, 8, 0]
    ccg = base[:, 9, 0]
    strans = base[:, 10, 0]
    flat = base[:, 11, 0]
    dt = base[:, 12, 0]

    dw = (1.0 - mw) * (1.0 - strans)
    lum = 0.212671 * c[:, 0] + 0.715160 * c[:, 1] + 0.072169 * c[:, 2]
    c_tint = jnp.where(lum[:, None] > 0.0, c / jnp.maximum(lum[:, None], 1e-20), 1.0)
    c_sheen = jnp.where(
        (sheen_w > 0.0)[:, None],
        (1.0 - stint)[:, None] + stint[:, None] * c_tint,
        0.0,
    )
    aspect = jnp.sqrt(jnp.maximum(1.0 - aniso * 0.9, 1e-6))
    ax = jnp.maximum(rough * rough / aspect, 0.001)
    ay = jnp.maximum(rough * rough * aspect, 0.001)
    r0_eta = ((e - 1.0) / jnp.maximum(e + 1.0, 1e-6)) ** 2
    c_spec0 = (1.0 - mw)[:, None] * (
        ((1.0 - st)[:, None] + st[:, None] * c_tint) * r0_eta[:, None]
    ) + mw[:, None] * c
    gloss = (1.0 - ccg) * 0.1 + ccg * 0.001
    t_trans = jnp.sqrt(jnp.maximum(c, 0.0)) * strans[:, None]
    rs_thin = (0.65 * e - 0.35) * rough
    axs = jnp.maximum(rs_thin * rs_thin / aspect, 0.001)
    ays = jnp.maximum(rs_thin * rs_thin * aspect, 0.001)

    # broadcast per-hit values over the lobe axis and write by role
    C = out.get("_C", 3)

    def bcast(v):  # (N,) -> (N, 1)
        return v[:, None]

    def bcast3(v):  # (N,3) -> (N, 1, C); spectral mode lifts per hit
        if C != 3:
            from ..core import spectral as _sp

            v = _sp.from_rgb(v, _sp.REFLECTANCE)
        return v[:, None, :]

    role_specs = [
        (DR_DIFFUSE, dw > 0.0, bcast3(c * dw[:, None]), None, None, None, None, None),
        (
            DR_DIFFUSE_THIN,
            dw > 0.0,
            bcast3(c * (dw * (1.0 - flat) * (1.0 - dt))[:, None]),
            None, None, None, None, None,
        ),
        (
            DR_FAKE_SS,
            dw > 0.0,
            bcast3(c * (dw * flat * (1.0 - dt))[:, None]),
            None, bcast(rough), None, None, None,
        ),
        (DR_RETRO, dw > 0.0, bcast3(c * dw[:, None]), None, bcast(rough), None, None, None),
        (
            DR_SHEEN,
            (dw > 0.0) & (sheen_w > 0.0),
            bcast3(c_sheen * (sheen_w * dw)[:, None]),
            None, None, None, None, None,
        ),
        (
            DR_MF_REFL,
            jnp.ones_like(dw, bool),
            None, bcast3(c_spec0), bcast(ax), bcast(ay), bcast(mw), bcast(e),
        ),
        (
            DR_CLEARCOAT,
            cc > 0.0,
            None, None, bcast(cc), bcast(gloss), None, None,
        ),
        (
            DR_MF_TRANS,
            strans > 0.0,
            bcast3(t_trans), None, bcast(ax), bcast(ay), None, bcast(e),
        ),
        (
            DR_MF_TRANS_THIN,
            strans > 0.0,
            bcast3(t_trans), None, bcast(axs), bcast(ays), None, bcast(e),
        ),
        (DR_LAMBERT_TRANS, jnp.ones_like(dw, bool), bcast3(c * dt[:, None]), None, None, None, None, None),
    ]

    kind = out["kind"]
    s0, s1 = out["s0"], out["s1"]
    au, av = out["alpha_u"], out["alpha_v"]
    ea, eb = out["eta_a"], out["eta_b"]
    for role, gate, v_s0, v_s1, v_au, v_av, v_ea, v_eb in role_specs:
        m = roles == role  # (N, L)
        kind = jnp.where(m & ~gate[:, None], LOBE_NONE, kind)
        if v_s0 is not None:
            s0 = jnp.where(m[..., None], v_s0, s0)
        if v_s1 is not None:
            s1 = jnp.where(m[..., None], v_s1, s1)
        if v_au is not None:
            au = jnp.where(m, v_au, au)
        if v_av is not None:
            av = jnp.where(m, v_av, av)
        if v_ea is not None:
            ea = jnp.where(m, v_ea, ea)
        if v_eb is not None:
            eb = jnp.where(m, v_eb, eb)
    out["kind"] = kind
    out["s0"] = s0
    out["s1"] = s1
    out["alpha_u"] = au
    out["alpha_v"] = av
    out["eta_a"] = ea
    out["eta_b"] = eb


def _slot(params, j):
    """Slice slot j from gathered (N,L,...) params -> per-lobe dict (N,...)."""
    out = {}
    for k, v in params.items():
        if k.startswith("_") or k in ("n_lobes", "eta"):
            out[k] = v
        else:
            out[k] = v[:, j]
    # unify eta storage: microfacet lobes use (f2,f3); specular use (f0,f1)
    is_spec_lobe = (
        (out["kind"] == LOBE_SPEC_REFL)
        | (out["kind"] == LOBE_SPEC_TRANS)
        | (out["kind"] == LOBE_FRESNEL_SPEC)
    )
    out["eta_a"] = jnp.where(is_spec_lobe, out["spec_eta_a"], out["eta_a"])
    out["eta_b"] = jnp.where(is_spec_lobe, out["spec_eta_b"], out["eta_b"])
    return out


def _matches(flags_lobe, kind, flags_query):
    """BxDF::match_flags (reflection.rs:490-492) + live lobe."""
    return (kind != LOBE_NONE) & ((flags_lobe & flags_query) == flags_lobe)


# ---- per-lobe f / pdf (non-specular; specular lobes return 0) ----


def _dist_d(p, wh):
    d_tr = mf.tr_d(wh, p["alpha_u"], p["alpha_v"])
    d_bk = mf.beckmann_d(wh, p["alpha_u"], p["alpha_v"])
    return jnp.where(p["dist"] == DIST_BECKMANN, d_bk, d_tr)


def _dist_lambda(p, w):
    l_tr = mf.tr_lambda(w, p["alpha_u"], p["alpha_v"])
    l_bk = mf.beckmann_lambda(w, p["alpha_u"], p["alpha_v"])
    return jnp.where(p["dist"] == DIST_BECKMANN, l_bk, l_tr)


def _oren_nayar_f(p, wo, wi):
    """(reflection.rs:916-945)"""
    sigma2 = (p["sigma"] * PI / 180.0) ** 2
    A = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - wi[..., 2] ** 2))
    sin_o = jnp.sqrt(jnp.maximum(0.0, 1.0 - wo[..., 2] ** 2))
    safe_i = jnp.where(sin_i == 0.0, 1.0, sin_i)
    safe_o = jnp.where(sin_o == 0.0, 1.0, sin_o)
    cpi, spi = wi[..., 0] / safe_i, wi[..., 1] / safe_i
    cpo, spo = wo[..., 0] / safe_o, wo[..., 1] / safe_o
    d_cos = jnp.maximum(cpi * cpo + spi * spo, 0.0)
    max_cos = jnp.where((sin_i > 1e-4) & (sin_o > 1e-4), d_cos, 0.0)
    aci, aco = _abs_cos(wi), _abs_cos(wo)
    use_i = aci > aco
    sin_alpha = jnp.where(use_i, sin_o, sin_i)
    tan_beta = jnp.where(use_i, sin_i / jnp.maximum(aci, 1e-9), sin_o / jnp.maximum(aco, 1e-9))
    return (p["s0"] / PI) * (A + B * max_cos * sin_alpha * tan_beta)[..., None]


def _mf_g(p, lam_o, lam_i):
    """G: height-correlated (microfacet.rs g()) or Disney separable
    G1*G1 (disney.rs:357-360)."""
    g = mf.g2(lam_o, lam_i)
    return jnp.where(
        p["dist"] == DIST_DISNEY_SEPARABLE_G, mf.g1(lam_o) * mf.g1(lam_i), g
    )


def _mf_refl_f(p, wo, wi):
    """(reflection.rs:969-989)"""
    co = _abs_cos(wo)
    ci = _abs_cos(wi)
    wh = wi + wo
    wh_len = vec.length(wh)
    ok = (co > 0.0) & (ci > 0.0) & (wh_len > 0.0)
    wh = wh / jnp.maximum(wh_len, 1e-20)[..., None]
    # fresnel with wh faceforward to +z (reflection.rs:983-986)
    whf = jnp.where(wh[..., 2:3] < 0.0, -wh, wh)
    fr = _fresnel_eval(p, vec.dot(wi, whf))
    d_val = _dist_d(p, wh)
    g_val = _mf_g(p, _dist_lambda(p, wo), _dist_lambda(p, wi))
    f = p["s0"] * fr * (d_val * g_val / jnp.maximum(4.0 * ci * co, 1e-20))[..., None]
    return jnp.where(ok[..., None], f, 0.0)


def _mf_trans_f(p, wo, wi, mode_radiance=True):
    """(reflection.rs:1059-1101)"""
    same = _same_hemisphere(wo, wi)
    co = wo[..., 2]
    ci = wi[..., 2]
    ok = (~same) & (co != 0.0) & (ci != 0.0)
    eta = jnp.where(co > 0.0, p["eta_b"] / p["eta_a"], p["eta_a"] / p["eta_b"])
    wh = vec.normalize(wo + wi * eta[..., None])
    wh = jnp.where(wh[..., 2:3] < 0.0, -wh, wh)
    fr = fr_dielectric(vec.dot(wo, wh), p["eta_a"], p["eta_b"])[..., None]
    sqrt_denom = vec.dot(wo, wh) + eta * vec.dot(wi, wh)
    factor = jnp.where(mode_radiance, 1.0 / eta, 1.0)
    d_val = _dist_d(p, wh)
    g_val = _mf_g(p, _dist_lambda(p, wo), _dist_lambda(p, wi))
    mag = jnp.abs(
        d_val
        * g_val
        * eta
        * eta
        * vec.absdot(wi, wh)
        * vec.absdot(wo, wh)
        * factor
        * factor
        / jnp.maximum(jnp.abs(ci * co * sqrt_denom * sqrt_denom), 1e-20)
    )
    f = (1.0 - fr) * p["s0"] * mag[..., None]
    return jnp.where(ok[..., None], f, 0.0)


def _fresnel_blend_f(p, wo, wi):
    """(reflection.rs:1178-1195)"""
    rd, rs = p["s0"], p["s1"]
    pow5 = lambda x: x**5
    diffuse = (
        rd
        * (0.28 / (23.0 * PI))
        * (1.0 - rs)
        * (1.0 - pow5(1.0 - 0.5 * _abs_cos(wi)))[..., None]
        * (1.0 - pow5(1.0 - 0.5 * _abs_cos(wo)))[..., None]
    )
    wh = wi + wo
    wh_zero = vec.length_squared(wh) == 0.0
    wh = vec.normalize(jnp.where(wh_zero[..., None], jnp.ones_like(wh), wh))
    schlick = rs + (1.0 - rs) * pow5(1.0 - vec.dot(wi, wh))[..., None]
    spec = (
        schlick
        * (
            _dist_d(p, wh)
            / jnp.maximum(
                4.0 * vec.absdot(wi, wh) * jnp.maximum(_abs_cos(wi), _abs_cos(wo)),
                1e-20,
            )
        )[..., None]
    )
    return jnp.where(wh_zero[..., None], 1.0, diffuse + spec)


def _has_kind(p, k):
    """Static scene-level gate: skip generating math for lobe kinds the
    packed material table never contains (big compile-time win)."""
    kinds = p.get("_kinds")
    return kinds is None or k in kinds


def lobe_f(p, wo, wi):
    """f(wo, wi) for one lobe slot: (N,C).  Specular kinds -> 0."""
    kind = p["kind"]
    f = jnp.zeros_like(p["s0"])
    if _has_kind(p, LOBE_LAMBERT_REFL) or _has_kind(p, LOBE_LAMBERT_TRANS):
        lam = p["s0"] / PI  # lambert refl AND trans share this form
        f = jnp.where(
            (kind == LOBE_LAMBERT_REFL)[..., None]
            | (kind == LOBE_LAMBERT_TRANS)[..., None],
            lam,
            f,
        )
    if _has_kind(p, LOBE_OREN_NAYAR):
        f = jnp.where((kind == LOBE_OREN_NAYAR)[..., None], _oren_nayar_f(p, wo, wi), f)
    if _has_kind(p, LOBE_MF_REFL) or _has_kind(p, LOBE_DISNEY_MICROFACET_REFL):
        is_mfr = (kind == LOBE_MF_REFL) | (kind == LOBE_DISNEY_MICROFACET_REFL)
        f = jnp.where(is_mfr[..., None], _mf_refl_f(p, wo, wi), f)
    if _has_kind(p, LOBE_MF_TRANS):
        f = jnp.where((kind == LOBE_MF_TRANS)[..., None], _mf_trans_f(p, wo, wi), f)
    if _has_kind(p, LOBE_FRESNEL_BLEND):
        f = jnp.where(
            (kind == LOBE_FRESNEL_BLEND)[..., None], _fresnel_blend_f(p, wo, wi), f
        )
    if _has_kind(p, LOBE_DEBUG_DIFFUSE):
        dbg_d = jnp.zeros_like(f).at[..., 1].set(1.0)
        f = jnp.where((kind == LOBE_DEBUG_DIFFUSE)[..., None], dbg_d, f)
    if _has_kind(p, LOBE_DEBUG_SPECULAR):
        # DebugSpecularBxdf::f is a CONSTANT (0,0,1) — unlike real specular
        # BxDFs it returns nonzero from f() (debug_material.rs:26-28), so
        # the Debug integrator's specular-chain children carry blue
        dbg_s = jnp.zeros_like(f).at[..., 2].set(1.0)
        f = jnp.where((kind == LOBE_DEBUG_SPECULAR)[..., None], dbg_s, f)
    # ---- Disney lobes (disney.rs) ----
    if _has_kind(p, LOBE_DISNEY_DIFFUSE):
        fo = _schlick_weight(_abs_cos(wo))
        fi = _schlick_weight(_abs_cos(wi))
        dd = p["s0"] / PI * ((1.0 - fo / 2.0) * (1.0 - fi / 2.0))[..., None]
        f = jnp.where((kind == LOBE_DISNEY_DIFFUSE)[..., None], dd, f)
    if (
        _has_kind(p, LOBE_DISNEY_FAKE_SS)
        or _has_kind(p, LOBE_DISNEY_RETRO)
        or _has_kind(p, LOBE_DISNEY_SHEEN)
    ):
        wh = wi + wo
        wh_zero = vec.length_squared(wh) == 0.0
        whn = vec.normalize(jnp.where(wh_zero[..., None], jnp.ones_like(wh), wh))
        cos_d = vec.dot(wi, whn)
        fo = _schlick_weight(_abs_cos(wo))
        fi = _schlick_weight(_abs_cos(wi))
        rough = p["alpha_u"]  # f0 slot carries Disney roughness
        if _has_kind(p, LOBE_DISNEY_FAKE_SS):
            fss90 = cos_d * cos_d * rough
            fss = (1.0 + fo * (fss90 - 1.0)) * (1.0 + fi * (fss90 - 1.0))
            ss = 1.25 * (
                fss * (1.0 / jnp.maximum(_abs_cos(wo) + _abs_cos(wi), 1e-9) - 0.5) + 0.5
            )
            v = p["s0"] / PI * ss[..., None]
            v = jnp.where(wh_zero[..., None], 0.0, v)
            f = jnp.where((kind == LOBE_DISNEY_FAKE_SS)[..., None], v, f)
        if _has_kind(p, LOBE_DISNEY_RETRO):
            rr = 2.0 * rough * cos_d * cos_d
            v = p["s0"] / PI * (rr * (fo + fi + fo * fi * (rr - 1.0)))[..., None]
            v = jnp.where(wh_zero[..., None], 0.0, v)
            f = jnp.where((kind == LOBE_DISNEY_RETRO)[..., None], v, f)
        if _has_kind(p, LOBE_DISNEY_SHEEN):
            v = p["s0"] * _schlick_weight(cos_d)[..., None]
            v = jnp.where(wh_zero[..., None], 0.0, v)
            f = jnp.where((kind == LOBE_DISNEY_SHEEN)[..., None], v, f)
    if _has_kind(p, LOBE_DISNEY_CLEARCOAT):
        v = _clearcoat_f(p, wo, wi)
        f = jnp.where((kind == LOBE_DISNEY_CLEARCOAT)[..., None], v, f)
    return f * p["scale"]


def _gtr1(cos_theta, alpha):
    """(disney.rs:20-24): note the reference's log10 (PBRT uses ln) —
    replicated for estimator parity since both D and pdf share it."""
    a2 = alpha * alpha
    return (a2 - 1.0) / (
        PI
        * jnp.log10(jnp.maximum(a2, 1e-9))
        * (1.0 + (a2 - 1.0) * cos_theta * cos_theta)
    )


def _smith_g_ggx(cos_theta, alpha):
    a2 = alpha * alpha
    c2 = cos_theta * cos_theta
    return 1.0 / jnp.maximum(
        cos_theta + jnp.sqrt(jnp.maximum(a2 + c2 - a2 * c2, 0.0)), 1e-9
    )


def _clearcoat_f(p, wo, wi):
    """(disney.rs DisneyClearcoat::f): weight in f0, gloss in f1 — mapped
    to alpha_u/alpha_v slots."""
    weight = p["alpha_u"]
    gloss = p["alpha_v"]
    wh = wi + wo
    wh_zero = vec.length_squared(wh) == 0.0
    whn = vec.normalize(jnp.where(wh_zero[..., None], jnp.ones_like(wh), wh))
    dr = _gtr1(_abs_cos(whn), gloss)
    fr = 0.04 + (1.0 - 0.04) * _schlick_weight(vec.dot(wo, whn))
    gr = _smith_g_ggx(_abs_cos(wo), 0.25) * _smith_g_ggx(_abs_cos(wi), 0.25)
    v = (weight * gr * fr * dr / 4.0)[..., None] * jnp.ones((1, 3), DTYPE)
    return jnp.where(wh_zero[..., None], 0.0, v)


def _clearcoat_pdf(p, wo, wi):
    gloss = p["alpha_v"]
    same = _same_hemisphere(wo, wi)
    wh = wi + wo
    wh_zero = vec.length_squared(wh) == 0.0
    whn = vec.normalize(jnp.where(wh_zero[..., None], jnp.ones_like(wh), wh))
    dr = _gtr1(_abs_cos(whn), gloss)
    pdf = dr * _abs_cos(whn) / jnp.maximum(4.0 * vec.dot(wo, whn), 1e-9)
    return jnp.where(same & ~wh_zero, pdf, 0.0)


def lobe_pdf(p, wo, wi):
    """pdf(wo, wi) for one lobe slot (N,).  Specular -> 0."""
    kind = p["kind"]
    same = _same_hemisphere(wo, wi)
    pdf = jnp.zeros(wo.shape[:-1], DTYPE)
    cos_pdf = jnp.where(same, _abs_cos(wi) / PI, 0.0)  # default BxDF::pdf
    pdf = jnp.where(
        (kind == LOBE_LAMBERT_REFL)
        | (kind == LOBE_OREN_NAYAR)
        | (kind == LOBE_DEBUG_DIFFUSE)
        | (kind == LOBE_DEBUG_SPECULAR)
        | (kind == LOBE_DISNEY_DIFFUSE)
        | (kind == LOBE_DISNEY_FAKE_SS)
        | (kind == LOBE_DISNEY_RETRO)
        | (kind == LOBE_DISNEY_SHEEN),
        cos_pdf,
        pdf,
    )
    if _has_kind(p, LOBE_DISNEY_CLEARCOAT):
        pdf = jnp.where(kind == LOBE_DISNEY_CLEARCOAT, _clearcoat_pdf(p, wo, wi), pdf)
    if _has_kind(p, LOBE_LAMBERT_TRANS):
        cos_pdf_trans = jnp.where(~same, _abs_cos(wi) / PI, 0.0)
        pdf = jnp.where(kind == LOBE_LAMBERT_TRANS, cos_pdf_trans, pdf)
    need_mf_r = (
        _has_kind(p, LOBE_MF_REFL)
        or _has_kind(p, LOBE_FRESNEL_BLEND)
        or _has_kind(p, LOBE_DISNEY_MICROFACET_REFL)
    )
    if need_mf_r or _has_kind(p, LOBE_MF_TRANS):
        lam_o = _dist_lambda(p, wo)
    if need_mf_r:
        # microfacet refl pdf (reflection.rs:1016-1022)
        wh_r = vec.normalize(wo + wi)
        pdf_wh = mf.mf_pdf(_dist_d(p, wh_r), lam_o, wo, wh_r, p["sample_visible"])
        mf_r = jnp.where(
            same, pdf_wh / jnp.maximum(4.0 * vec.dot(wo, wh_r), 1e-20), 0.0
        )
        pdf = jnp.where(
            (kind == LOBE_MF_REFL) | (kind == LOBE_DISNEY_MICROFACET_REFL), mf_r, pdf
        )
        # fresnel blend pdf (reflection.rs:1226-1233)
        fb = jnp.where(
            same,
            0.5
            * (
                _abs_cos(wi) / PI
                + pdf_wh / jnp.maximum(4.0 * vec.dot(wo, wh_r), 1e-20)
            ),
            0.0,
        )
        pdf = jnp.where(kind == LOBE_FRESNEL_BLEND, fb, pdf)
    if _has_kind(p, LOBE_MF_TRANS):
        # microfacet trans pdf (reflection.rs:1129-1147)
        eta = jnp.where(
            wo[..., 2] > 0.0, p["eta_b"] / p["eta_a"], p["eta_a"] / p["eta_b"]
        )
        wh_t = vec.normalize(wo + wi * eta[..., None])
        sq = vec.dot(wo, wh_t) + eta * vec.dot(wi, wh_t)
        dwh_dwi = jnp.abs(
            (eta * eta * vec.dot(wi, wh_t)) / jnp.maximum(sq * sq, 1e-20)
        )
        mf_t = jnp.where(
            ~same,
            mf.mf_pdf(_dist_d(p, wh_t), lam_o, wo, wh_t, p["sample_visible"])
            * dwh_dwi,
            0.0,
        )
        pdf = jnp.where(kind == LOBE_MF_TRANS, mf_t, pdf)
    return pdf


# ---- public API mirroring Bsdf ----


def num_components(params, flags):
    """Bsdf::num_components over gathered lobes: (N,) int."""
    count = jnp.zeros(params["kind"].shape[0], jnp.int32)
    for j in range(params["kind"].shape[1]):
        p = _slot(params, j)
        count += _matches(p["flags"], p["kind"], flags).astype(jnp.int32)
    return count


def bsdf_f(params, fr: Frame, wo_w, wi_w, flags):
    """Bsdf::f (reflection.rs:252-268): sum matching lobes with the
    geometric-normal reflect/transmit gate."""
    wo = world_to_local(fr, wo_w)
    wi = world_to_local(fr, wi_w)
    reflect = (vec.dot(wi_w, fr.ng) * vec.dot(wo_w, fr.ng)) > 0.0
    total = jnp.zeros(wo_w.shape[:-1] + (params["s0"].shape[-1],), DTYPE)
    for j in range(params["kind"].shape[1]):
        p = _slot(params, j)
        is_refl = (p["flags"] & BXDF_REFLECTION) > 0
        is_trans = (p["flags"] & BXDF_TRANSMISSION) > 0
        use = _matches(p["flags"], p["kind"], flags) & (
            (reflect & is_refl) | ((~reflect) & is_trans)
        )
        total = total + jnp.where(use[..., None], lobe_f(p, wo, wi), 0.0)
    ok = wo[..., 2] != 0.0
    return jnp.where(ok[..., None], total, 0.0)


def bsdf_pdf(params, fr: Frame, wo_w, wi_w, flags):
    """Bsdf::pdf (reflection.rs:382-404): mean over matching lobes."""
    wo = world_to_local(fr, wo_w)
    wi = world_to_local(fr, wi_w)
    total = jnp.zeros(wo.shape[0], DTYPE)
    count = jnp.zeros(wo.shape[0], jnp.int32)
    for j in range(params["kind"].shape[1]):
        p = _slot(params, j)
        m = _matches(p["flags"], p["kind"], flags)
        total = total + jnp.where(m, lobe_pdf(p, wo, wi), 0.0)
        count += m.astype(jnp.int32)
    ok = (wo[..., 2] != 0.0) & (count > 0)
    return jnp.where(ok, total / jnp.maximum(count, 1), 0.0)


class BsdfSample(NamedTuple):
    f: jnp.ndarray  # (N,3)
    wi_world: jnp.ndarray  # (N,3)
    pdf: jnp.ndarray  # (N,)
    sampled_flags: jnp.ndarray  # (N,) int32
    valid: jnp.ndarray  # (N,) bool


def _lobe_sample(p, wo, u, mode_radiance=True):
    """sample_f for one chosen lobe: (f, wi, pdf, is_specular_branch_flags).

    Handles every lobe kind branch-free; the caller selects via p['kind'].
    """
    kind = p["kind"]
    n = wo.shape[0]

    # default cosine-hemisphere sample (BxDF::sample_f, reflection.rs:428-443)
    wi_cos = cosine_sample_hemisphere(u)
    wi_cos = jnp.where(
        (wo[..., 2] < 0.0)[..., None],
        wi_cos * jnp.asarray([1.0, 1.0, -1.0], DTYPE),
        wi_cos,
    )
    # lambert transmission flips the OTHER way (reflection.rs:857-871)
    wi_lt = wi_cos * jnp.asarray([1.0, 1.0, -1.0], DTYPE)

    # specular reflection (reflection.rs:638-649)
    wi_sr = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)

    need_st = (
        _has_kind(p, LOBE_SPEC_TRANS)
        or _has_kind(p, LOBE_FRESNEL_SPEC)
        or _has_kind(p, LOBE_MF_TRANS)
    )
    need_mf = (
        _has_kind(p, LOBE_MF_REFL)
        or _has_kind(p, LOBE_MF_TRANS)
        or _has_kind(p, LOBE_DISNEY_MICROFACET_REFL)
    )
    need_fb = _has_kind(p, LOBE_FRESNEL_BLEND)
    need_cc = _has_kind(p, LOBE_DISNEY_CLEARCOAT)

    # specular transmission (reflection.rs:686-715)
    entering = wo[..., 2] > 0.0
    eta_i = jnp.where(entering, p["eta_a"], p["eta_b"])
    eta_t = jnp.where(entering, p["eta_b"], p["eta_a"])
    if need_st:
        nrm = jnp.concatenate(
            [jnp.zeros((n, 2), DTYPE), jnp.where(entering, 1.0, -1.0)[..., None]],
            axis=-1,
        )
        wi_st, st_ok = vec.refract(wo, nrm, eta_i / eta_t)
    else:
        wi_st = jnp.zeros_like(wo)
        st_ok = jnp.zeros((n,), bool)

    # microfacet reflection sample (reflection.rs:990-1015)
    if need_mf:
        wh_vis = mf.tr_sample_wh_visible(wo, p["alpha_u"], p["alpha_v"], u)
        wh_full = mf.tr_sample_wh_full(wo, p["alpha_u"], p["alpha_v"], u)
        if p.get("_has_beckmann"):
            # Beckmann lobes sample their own wh (microfacet.rs sample_wh)
            bk_vis = mf.beckmann_sample_wh_visible(
                wo, p["alpha_u"], p["alpha_v"], u
            )
            bk_full = mf.beckmann_sample_wh_full(
                wo, p["alpha_u"], p["alpha_v"], u
            )
            is_bk = (p["dist"] == DIST_BECKMANN)[..., None]
            wh_vis = jnp.where(is_bk, bk_vis, wh_vis)
            wh_full = jnp.where(is_bk, bk_full, wh_full)
        wh = jnp.where(p["sample_visible"][..., None], wh_vis, wh_full)
        wi_mr = vec.reflect(wo, wh)
        mr_ok = (
            (vec.dot(wo, wh) >= 0.0)
            & _same_hemisphere(wo, wi_mr)
            & (wo[..., 2] != 0.0)
        )
    else:
        wh = jnp.concatenate(
            [jnp.zeros((n, 2), DTYPE), jnp.ones((n, 1), DTYPE)], axis=-1
        )
        wi_mr = jnp.zeros_like(wo)
        mr_ok = jnp.zeros((n,), bool)

    # microfacet transmission sample (reflection.rs:1102-1128)
    if _has_kind(p, LOBE_MF_TRANS):
        eta_mt = jnp.where(entering, p["eta_a"] / p["eta_b"], p["eta_b"] / p["eta_a"])
        wht_ff = jnp.where((vec.dot(wo, wh) < 0.0)[..., None], -wh, wh)
        wi_mt, mt_refr_ok = vec.refract(wo, wht_ff, eta_mt)
        mt_ok = (vec.dot(wo, wh) >= 0.0) & mt_refr_ok & (wo[..., 2] != 0.0)
    else:
        wi_mt = jnp.zeros_like(wo)
        mt_ok = jnp.zeros((n,), bool)

    # fresnel specular branch selection (reflection.rs:755-797)
    if _has_kind(p, LOBE_FRESNEL_SPEC):
        fr_fs = fr_dielectric(wo[..., 2], p["eta_a"], p["eta_b"])
    else:
        fr_fs = jnp.zeros((n,), DTYPE)
    fs_reflect = u[..., 0] < fr_fs

    # fresnel blend (reflection.rs:1196-1225): u0<0.5 -> cosine, else wh
    fb_cos = u[..., 0] < 0.5
    if need_fb:
        u0_fb = jnp.where(
            fb_cos,
            jnp.minimum(2.0 * u[..., 0], ONE_MINUS_EPSILON),
            jnp.minimum(2.0 * (u[..., 0] - 0.5), ONE_MINUS_EPSILON),
        )
        u_fb = jnp.stack([u0_fb, u[..., 1]], axis=-1)
        wi_fb_cos = cosine_sample_hemisphere(u_fb)
        wi_fb_cos = jnp.where(
            (wo[..., 2] < 0.0)[..., None],
            wi_fb_cos * jnp.asarray([1.0, 1.0, -1.0], DTYPE),
            wi_fb_cos,
        )
        wh_fb = jnp.where(
            p["sample_visible"][..., None],
            mf.tr_sample_wh_visible(wo, p["alpha_u"], p["alpha_v"], u_fb),
            mf.tr_sample_wh_full(wo, p["alpha_u"], p["alpha_v"], u_fb),
        )
        wi_fb_spec = vec.reflect(wo, wh_fb)
        wi_fb = jnp.where(fb_cos[..., None], wi_fb_cos, wi_fb_spec)
        fb_ok = fb_cos | _same_hemisphere(wo, wi_fb)
    else:
        wi_fb = jnp.zeros_like(wo)
        fb_ok = jnp.zeros((n,), bool)

    # clearcoat GTR1 wh sampling (disney.rs DisneyClearcoat::sample_f)
    if need_cc:
        gloss = p["alpha_v"]
        a2 = gloss * gloss
        # reference literal form: (1 - a2^(1-u)) / sqrt(max(1-a2, 0))
        cc_cos = (1.0 - jnp.power(jnp.maximum(a2, 1e-9), 1.0 - u[..., 0])) / jnp.sqrt(
            jnp.maximum(1.0 - a2, 1e-9)
        )
        cc_cos = jnp.clip(cc_cos, -1.0, 1.0)
        cc_sin = jnp.sqrt(jnp.maximum(0.0, 1.0 - cc_cos * cc_cos))
        cc_phi = 2.0 * PI * u[..., 1]
        wh_cc = vec.spherical_direction(cc_sin, cc_cos, cc_phi)
        wh_cc = jnp.where(
            _same_hemisphere(wo, wh_cc)[..., None], wh_cc, -wh_cc
        )
        wi_cc = vec.reflect(wo, wh_cc)
        cc_ok = _same_hemisphere(wo, wi_cc) & (wo[..., 2] != 0.0)
    else:
        wi_cc = jnp.zeros_like(wo)
        cc_ok = jnp.zeros((n,), bool)

    # --- select wi by kind ---
    is_cosine_kind = (
        (kind == LOBE_LAMBERT_REFL)
        | (kind == LOBE_OREN_NAYAR)
        | (kind == LOBE_DEBUG_DIFFUSE)
        | (kind == LOBE_DEBUG_SPECULAR)
        | (kind == LOBE_DISNEY_DIFFUSE)
        | (kind == LOBE_DISNEY_FAKE_SS)
        | (kind == LOBE_DISNEY_RETRO)
        | (kind == LOBE_DISNEY_SHEEN)
    )
    wi = jnp.where(is_cosine_kind[..., None], wi_cos, jnp.zeros_like(wo))
    wi = jnp.where((kind == LOBE_LAMBERT_TRANS)[..., None], wi_lt, wi)
    wi = jnp.where((kind == LOBE_SPEC_REFL)[..., None], wi_sr, wi)
    wi = jnp.where((kind == LOBE_SPEC_TRANS)[..., None], wi_st, wi)
    wi = jnp.where(
        (kind == LOBE_FRESNEL_SPEC)[..., None],
        jnp.where(fs_reflect[..., None], wi_sr, wi_st),
        wi,
    )
    wi = jnp.where(
        ((kind == LOBE_MF_REFL) | (kind == LOBE_DISNEY_MICROFACET_REFL))[..., None],
        wi_mr,
        wi,
    )
    wi = jnp.where((kind == LOBE_DISNEY_CLEARCOAT)[..., None], wi_cc, wi)
    wi = jnp.where((kind == LOBE_MF_TRANS)[..., None], wi_mt, wi)
    wi = jnp.where((kind == LOBE_FRESNEL_BLEND)[..., None], wi_fb, wi)

    # --- pdf by kind ---
    pdf = jnp.where(is_cosine_kind, lobe_pdf(p, wo, wi), 0.0)
    pdf = jnp.where(kind == LOBE_LAMBERT_TRANS, lobe_pdf(p, wo, wi), pdf)
    pdf = jnp.where(kind == LOBE_SPEC_REFL, 1.0, pdf)
    pdf = jnp.where(kind == LOBE_SPEC_TRANS, jnp.where(st_ok, 1.0, 0.0), pdf)
    pdf = jnp.where(
        kind == LOBE_FRESNEL_SPEC, jnp.where(fs_reflect, fr_fs, 1.0 - fr_fs), pdf
    )
    if need_mf:
        lam_o = _dist_lambda(p, wo)
        mr_pdf = mf.mf_pdf(
            _dist_d(p, wh), lam_o, wo, wh, p["sample_visible"]
        ) / jnp.maximum(4.0 * vec.dot(wo, wh), 1e-20)
        pdf = jnp.where(
            (kind == LOBE_MF_REFL) | (kind == LOBE_DISNEY_MICROFACET_REFL),
            jnp.where(mr_ok, mr_pdf, 0.0),
            pdf,
        )
    if _has_kind(p, LOBE_MF_TRANS):
        pdf = jnp.where(
            kind == LOBE_MF_TRANS, jnp.where(mt_ok, lobe_pdf(p, wo, wi), 0.0), pdf
        )
    if need_fb:
        pdf = jnp.where(
            kind == LOBE_FRESNEL_BLEND,
            jnp.where(fb_ok, lobe_pdf(p, wo, wi), 0.0),
            pdf,
        )
    if need_cc:
        pdf = jnp.where(
            kind == LOBE_DISNEY_CLEARCOAT,
            jnp.where(cc_ok, _clearcoat_pdf(p, wo, wi), 0.0),
            pdf,
        )

    # --- f by kind ---
    f = lobe_f(p, wo, wi)  # covers non-specular kinds
    aci = jnp.maximum(_abs_cos(wi), 1e-20)
    # specular reflection f (reflection.rs:646-648)
    f_sr = _fresnel_eval(p, wi[..., 2]) * p["s0"] / aci[..., None]
    f = jnp.where((kind == LOBE_SPEC_REFL)[..., None], f_sr * p["scale"], f)
    # specular transmission f (reflection.rs:706-714), radiance mode
    fr_t = fr_dielectric(wi[..., 2], p["eta_a"], p["eta_b"])[..., None]
    scale_t = (eta_i * eta_i) / jnp.maximum(eta_t * eta_t, 1e-20)
    f_st = p["s0"] * (1.0 - fr_t) * scale_t[..., None] / aci[..., None]
    f = jnp.where(
        (kind == LOBE_SPEC_TRANS)[..., None],
        jnp.where(st_ok[..., None], f_st * p["scale"], 0.0),
        f,
    )
    # fresnel specular f: reflect branch uses s0, transmit branch s1
    f_fs_r = p["s0"] * fr_fs[..., None] / aci[..., None]
    f_fs_t = p["s1"] * ((1.0 - fr_fs) * scale_t)[..., None] / aci[..., None]
    f_fs = jnp.where(fs_reflect[..., None], f_fs_r, jnp.where(st_ok[..., None], f_fs_t, 0.0))
    f = jnp.where((kind == LOBE_FRESNEL_SPEC)[..., None], f_fs * p["scale"], f)

    # sampled flags: FRESNEL_SPEC resolves to the branch taken
    flags = p["flags"]
    fs_flags = jnp.where(
        fs_reflect,
        BXDF_SPECULAR | BXDF_REFLECTION,
        BXDF_SPECULAR | BXDF_TRANSMISSION,
    ).astype(jnp.int32)
    sampled_flags = jnp.where(kind == LOBE_FRESNEL_SPEC, fs_flags, flags)

    bad = (
        (((kind == LOBE_MF_REFL) | (kind == LOBE_DISNEY_MICROFACET_REFL)) & ~mr_ok)
        | ((kind == LOBE_DISNEY_CLEARCOAT) & ~cc_ok)
        | ((kind == LOBE_MF_TRANS) & ~mt_ok)
        | ((kind == LOBE_SPEC_TRANS) & ~st_ok)
        | ((kind == LOBE_FRESNEL_BLEND) & ~fb_ok)
    )
    f = jnp.where(bad[..., None], 0.0, f)
    pdf = jnp.where(bad, 0.0, pdf)
    return f, wi, pdf, sampled_flags


def bsdf_sample(params, fr: Frame, wo_w, u, flags):
    """Bsdf::sample_f (reflection.rs:302-381), reference-quirk-exact."""
    n = wo_w.shape[0]
    wo = world_to_local(fr, wo_w)

    L_slots = params["kind"].shape[1]
    match = jnp.zeros((n, L_slots), bool)
    for j in range(params["kind"].shape[1]):
        p = _slot(params, j)
        match = match.at[:, j].set(_matches(p["flags"], p["kind"], flags))
    matching = jnp.sum(match, axis=-1).astype(jnp.int32)

    comp = jnp.minimum(
        jnp.floor(u[..., 0] * matching).astype(jnp.int32), matching
    )
    # chosen slot = index of the (comp+1)-th matching lobe
    cum = jnp.cumsum(match.astype(jnp.int32), axis=-1)
    chosen = jnp.argmax((cum == (comp + 1)[:, None]) & match, axis=-1).astype(jnp.int32)

    # remap u0 (reflection.rs:337-341)
    u0r = jnp.minimum(
        u[..., 0] * matching - comp.astype(DTYPE), ONE_MINUS_EPSILON
    )
    u_re = jnp.stack([u0r, u[..., 1]], axis=-1)

    # gather chosen lobe params
    pc = {}
    for k, v in params.items():
        if k.startswith("_") or k in ("n_lobes", "eta"):
            pc[k] = v
        else:
            from ..core.tableops import take_axis1

            pc[k] = take_axis1(v, chosen)
    pc = {**pc}
    is_spec_lobe = (
        (pc["kind"] == LOBE_SPEC_REFL)
        | (pc["kind"] == LOBE_SPEC_TRANS)
        | (pc["kind"] == LOBE_FRESNEL_SPEC)
    )
    pc["eta_a"] = jnp.where(is_spec_lobe, pc["spec_eta_a"], pc["eta_a"])
    pc["eta_b"] = jnp.where(is_spec_lobe, pc["spec_eta_b"], pc["eta_b"])

    f, wi, pdf, sampled_flags = _lobe_sample(pc, wo, u_re)

    # pdf accumulation over other matching lobes.
    # REFERENCE_QUIRKS: gate is `!chosen.is_refl()` (reflection.rs:358),
    # where PBRT uses `!is_specular`.
    if REFERENCE_QUIRKS:
        accumulate = ((pc["flags"] & BXDF_REFLECTION) == 0) & (matching > 1)
    else:
        accumulate = ((pc["flags"] & BXDF_SPECULAR) == 0) & (matching > 1)
    extra = jnp.zeros(n, DTYPE)
    for j in range(params["kind"].shape[1]):
        p = _slot(params, j)
        use = match[:, j] & (chosen != j)
        extra = extra + jnp.where(use, lobe_pdf(p, wo, wi), 0.0)
    pdf = pdf + jnp.where(accumulate, extra, 0.0)
    pdf = jnp.where(matching > 1, pdf / jnp.maximum(matching, 1), pdf)

    if not REFERENCE_QUIRKS:
        # PBRT-exact: recompute f over all matching lobes for non-specular
        # chosen lobes.  (The reference computes this and discards it,
        # reflection.rs:369-379.)
        reflect = (vec.dot(local_to_world(fr, wi), fr.ng) * vec.dot(wo_w, fr.ng)) > 0.0
        fsum = jnp.zeros_like(f)
        for j in range(params["kind"].shape[1]):
            p = _slot(params, j)
            is_refl = (p["flags"] & BXDF_REFLECTION) > 0
            is_trans = (p["flags"] & BXDF_TRANSMISSION) > 0
            use = match[:, j] & ((reflect & is_refl) | ((~reflect) & is_trans))
            fsum = fsum + jnp.where(use[..., None], lobe_f(p, wo, wi), 0.0)
        not_spec = (pc["flags"] & BXDF_SPECULAR) == 0
        f = jnp.where(not_spec[..., None], fsum, f)

    valid = (matching > 0) & (wo[..., 2] != 0.0) & (pdf > 0.0)
    wi_w = local_to_world(fr, wi)
    return BsdfSample(
        f=jnp.where(valid[..., None], f, 0.0),
        wi_world=wi_w,
        pdf=jnp.where(valid, pdf, 0.0),
        sampled_flags=jnp.where(valid, sampled_flags, 0),
        valid=valid,
    )


def bsdf_f_pdf(params, fr: Frame, wo_w, wi_w, flags):
    """Fused Bsdf::f + Bsdf::pdf for NEE (one local-frame transform and one
    lobe-slot sweep instead of two)."""
    wo = world_to_local(fr, wo_w)
    wi = world_to_local(fr, wi_w)
    reflect = (vec.dot(wi_w, fr.ng) * vec.dot(wo_w, fr.ng)) > 0.0
    f_total = jnp.zeros(wo_w.shape[:-1] + (params["s0"].shape[-1],), DTYPE)
    p_total = jnp.zeros(wo.shape[0], DTYPE)
    count = jnp.zeros(wo.shape[0], jnp.int32)
    for j in range(params["kind"].shape[1]):
        p = _slot(params, j)
        m = _matches(p["flags"], p["kind"], flags)
        is_refl = (p["flags"] & BXDF_REFLECTION) > 0
        is_trans = (p["flags"] & BXDF_TRANSMISSION) > 0
        use_f = m & ((reflect & is_refl) | ((~reflect) & is_trans))
        f_total = f_total + jnp.where(use_f[..., None], lobe_f(p, wo, wi), 0.0)
        p_total = p_total + jnp.where(m, lobe_pdf(p, wo, wi), 0.0)
        count += m.astype(jnp.int32)
    ok = wo[..., 2] != 0.0
    f_total = jnp.where(ok[..., None], f_total, 0.0)
    pdf = jnp.where(ok & (count > 0), p_total / jnp.maximum(count, 1), 0.0)
    return f_total, pdf
