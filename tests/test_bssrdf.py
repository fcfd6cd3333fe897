"""BSSRDF unit + probe-chain tests (bssrdf.rs:32-279, disney.rs 374-529).

Profile math is checked against its analytic invariants:
  * the Burley Sr integrates to the albedo R:  ∫₀^∞ Sr(r)·2πr dr = R
  * pdf_sr is a normalized area density:       ∫₀^∞ pdf·2πr dr = 1
  * sample_sr follows the analytic mixture CDF
  * fresnel_moment1(η) = ∫₀¹ Fr(μ; 1→1/η)·μ dμ (the PBRT fit's definition)

The probe chain (sample_sp, bssrdf.rs:107-193) is exercised on a real
scene: a single axis-aligned cube with a Disney scatter_distance material.
"""

import json
import os
import shutil
import tempfile

import numpy as np
import jax.numpy as jnp

from rs_ray_toy_tpu.bsdf import bssrdf as bss
from rs_ray_toy_tpu.bsdf.eval import fr_dielectric

from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR as SAMPLES


def test_sr_profile_integrates_to_albedo():
    R = jnp.asarray([[0.8, 0.5, 0.2]])
    d = jnp.asarray([[1.0, 0.5, 0.25]])
    r = np.linspace(1e-5, 40, 200001).astype(np.float32)
    Sr = np.asarray(bss.sr_profile(R, d, jnp.asarray(r)))
    integ = np.trapezoid(Sr * 2 * np.pi * r[:, None], r, axis=0)
    np.testing.assert_allclose(integ, [0.8, 0.5, 0.2], rtol=1e-3)


def test_pdf_sr_normalized():
    r = np.linspace(1e-5, 40, 200001).astype(np.float32)
    for d_ch in (1.0, 0.5, 0.25):
        p = np.asarray(bss.pdf_sr(jnp.float32(d_ch), jnp.asarray(r)))
        np.testing.assert_allclose(
            np.trapezoid(p * 2 * np.pi * r, r), 1.0, rtol=1e-4
        )


def test_sample_sr_matches_analytic_cdf():
    """CDF of the 1:3 exponential mixture (disney.rs sample_sr):
    F(r) = 0.25(1-e^{-r/d}) + 0.75(1-e^{-r/3d})."""
    d = 0.7
    u = np.random.default_rng(0).uniform(size=200000).astype(np.float32)
    rs = np.asarray(bss.sample_sr(jnp.float32(d), jnp.asarray(u)))
    for q in (0.3, 0.7, 1.5, 3.0):
        ana = 0.25 * (1 - np.exp(-q / d)) + 0.75 * (1 - np.exp(-q / (3 * d)))
        assert abs((rs < q).mean() - ana) < 4e-3


def test_fresnel_moment1_matches_numeric_integral():
    """bssrdf.rs:443-457 is a polynomial fit of ∫₀¹ Fr(μ; rel. IOR 1/η)·μ dμ."""
    mu = np.linspace(1e-4, 1.0, 20001)
    for eta in (1.33, 1.5, 1 / 1.33, 1 / 1.5):
        fr = np.asarray(
            fr_dielectric(jnp.asarray(mu, jnp.float32), 1.0, jnp.float32(1.0 / eta))
        )
        num = float(np.trapezoid(fr * mu, mu))
        fit = float(bss.fresnel_moment1(jnp.float32(eta)))
        assert abs(num - fit) < 2e-3, (eta, num, fit)


def test_sw_adapter_form():
    """Sw (bssrdf.rs:250-279): f = η²(1-Fr(cos))/(cπ), c = 1-2·fm1(1/η)."""
    eta = jnp.float32(1.4)
    cosw = jnp.asarray([0.1, 0.5, 0.9], jnp.float32)
    got = np.asarray(bss.sw_f(eta, cosw))
    c = 1.0 - 2.0 * float(bss.fresnel_moment1(1.0 / eta))
    want = (
        float(eta) ** 2
        * (1.0 - np.asarray(fr_dielectric(cosw, 1.0, eta)))
        / (c * np.pi)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(got > 0)


# ---- probe chain on a real scene ----


def _bssrdf_ctx(scale=6.0):
    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["materials"] = [
        {
            "material_type": "DisneyMaterial",
            "material_name": "mat_sss",
            "color": {"values": [0.8, 0.6, 0.4]},
            "scatter_distance": {"values": [1.0, 0.8, 0.6]},
            "roughness": 0.3,
        }
    ]
    cfg["Aggregate"]["primitives"] = [
        {
            "primitive_type": "triangle",
            "material_name": "mat_sss",
            "obj_name": "cube_01",
            "instances": [{"world_pos": [0.0, 0.0, 0.0], "scale": [scale] * 3}],
        }
    ]
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene
    from rs_ray_toy_tpu.integrators.common import SceneCtx

    job = load_scene(path)
    return SceneCtx(job.scene)


def test_probe_chain_exits_on_surface():
    """Entry points on the +y face of a 12-unit cube: every valid BSSRDF
    sample must exit on the cube surface (|component|=6 on some axis),
    carry a positive pdf and Sp, and keep the entry material."""
    ctx = _bssrdf_ctx()
    assert bool(np.any(np.asarray(ctx.mats["has_bssrdf"])))

    n = 256
    rng = np.random.default_rng(1)
    # rays straight down onto the top face
    o = np.stack(
        [
            rng.uniform(-3.0, 3.0, n),
            np.full(n, 12.0),
            rng.uniform(-3.0, 3.0, n),
        ],
        -1,
    ).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    hit = ctx.intersect(jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 1e9, jnp.float32))
    si = ctx.surface(hit, jnp.asarray(o), jnp.asarray(d))
    assert bool(jnp.all(hit.valid))
    frame = ctx.frame(si)

    u1 = jnp.asarray(rng.uniform(size=n).astype(np.float32))
    u2 = jnp.asarray(rng.uniform(size=(n, 2)).astype(np.float32))
    samp = bss.sample_bssrdf(ctx, si, frame, u1, u2)
    valid = np.asarray(samp.valid)
    # the top face is wide open around every entry: most probes must land
    assert valid.mean() > 0.4, valid.mean()

    p_exit = np.asarray(samp.pi.p)[valid]
    # on the cube surface: max |coord| == 4 within float tolerance
    face_dist = np.abs(np.abs(p_exit).max(axis=1) - 6.0)
    assert face_dist.max() < 1e-3, face_dist.max()

    assert np.all(np.asarray(samp.pdf)[valid] > 0)
    assert np.all(np.asarray(samp.sp)[valid] >= 0)
    assert np.asarray(samp.sp)[valid].max() > 0
    # exit interaction keeps the subsurface material
    assert np.all(np.asarray(samp.pi.mat)[valid] == np.asarray(si.mat)[valid])


def test_probe_chain_ns_axis_radius_exact():
    """With u1 < 0.5 the projection frame is the shading frame
    (bssrdf.rs:118-127): on a flat face the exit radius equals the
    sampled Sr radius exactly."""
    ctx = _bssrdf_ctx()
    n = 128
    rng = np.random.default_rng(2)
    o = np.stack(
        [
            rng.uniform(-1.5, 1.5, n),
            np.full(n, 12.0),
            rng.uniform(-1.5, 1.5, n),
        ],
        -1,
    ).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    hit = ctx.intersect(jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 1e9, jnp.float32))
    si = ctx.surface(hit, jnp.asarray(o), jnp.asarray(d))
    frame = ctx.frame(si)

    u1 = jnp.asarray(rng.uniform(0.0, 0.5, n).astype(np.float32))  # ns axis
    u2 = jnp.asarray(rng.uniform(size=(n, 2)).astype(np.float32))
    samp = bss.sample_bssrdf(ctx, si, frame, u1, u2)
    valid = np.asarray(samp.valid)
    assert valid.sum() > 32

    # recompute the expected radius with the module's own remapping
    u = np.asarray(u1) * 2.0
    ch = np.clip((u * 3).astype(np.int32), 0, 2)
    u_r = u * u * 3.0 - ch  # reference's squared-u remap quirk
    mats = ctx.mats
    mat_id = np.maximum(np.asarray(si.mat), 0)
    d_prof = np.asarray(mats["bssrdf_d"])[mat_id]
    d_ch = d_prof[np.arange(n), ch]
    r_want = np.asarray(
        bss.sample_sr(jnp.asarray(d_ch), jnp.asarray(np.asarray(u2)[:, 0]))
    )
    r_got = np.linalg.norm(
        np.asarray(samp.pi.p) - np.asarray(si.p), axis=1
    )
    np.testing.assert_allclose(r_got[valid], r_want[valid], rtol=1e-3, atol=1e-4)
