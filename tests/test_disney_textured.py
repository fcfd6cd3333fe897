"""Textured-Disney per-hit assembly tests (disney.rs:530-676).

The device assembly (eval._assemble_disney_textured) must reproduce the
constant-recipe lobe set exactly when fed the same values, and a real
texture must actually vary the BSDF per hit.
"""

import numpy as np

from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR as SAMPLES
import pytest
import jax.numpy as jnp

from rs_ray_toy_tpu.bsdf import eval as beval
from rs_ray_toy_tpu.bsdf import recipes
from rs_ray_toy_tpu.bsdf.lobes import BXDF_ALL, MaterialTableBuilder
from rs_ray_toy_tpu.bsdf.recipes import FloatParam, RGBParam, _disney_textured
from rs_ray_toy_tpu.core import vec

from tests.test_bsdf import _flat_frame, _mats


DIS_ARGS = dict(
    color=np.array([0.6, 0.3, 0.2]),
    metallic=0.3,
    eta=1.5,
    roughness=0.4,
    specular_tint=0.2,
    anisotropic=0.1,
    sheen=0.5,
    sheen_tint=0.5,
    clearcoat=0.8,
    clearcoat_gloss=0.9,
    spec_trans=0.3,
    flatness=0.4,
    diff_trans=0.6,
)


def _const_disney(thin, **over):
    a = {**DIS_ARGS, **over}
    return recipes.disney(
        "c",
        RGBParam(np.asarray(a["color"])),
        FloatParam(a["metallic"]), FloatParam(a["eta"]),
        FloatParam(a["roughness"]), FloatParam(a["specular_tint"]),
        FloatParam(a["anisotropic"]), FloatParam(a["sheen"]),
        FloatParam(a["sheen_tint"]), FloatParam(a["clearcoat"]),
        FloatParam(a["clearcoat_gloss"]), FloatParam(a["spec_trans"]),
        RGBParam(np.zeros(3)), thin, FloatParam(a["flatness"]),
        FloatParam(a["diff_trans"]),
    )


def _tex_disney(thin, **over):
    a = {**DIS_ARGS, **over}
    base = (
        RGBParam(np.asarray(a["color"])),
        FloatParam(a["metallic"]), FloatParam(a["eta"]),
        FloatParam(a["roughness"]), FloatParam(a["specular_tint"]),
        FloatParam(a["anisotropic"]), FloatParam(a["sheen"]),
        FloatParam(a["sheen_tint"]), FloatParam(a["clearcoat"]),
        FloatParam(a["clearcoat_gloss"]), FloatParam(a["spec_trans"]),
        FloatParam(a["flatness"]), FloatParam(a["diff_trans"]),
    )
    return _disney_textured("t", base, thin, -1)


def _compare(thin, **over):
    m_const = _const_disney(thin, **over)
    m_tex = _tex_disney(thin, **over)
    n = 64
    fr = _flat_frame(n)
    rng = np.random.default_rng(7)
    wo = vec.normalize(
        jnp.asarray(rng.normal(size=(n, 3)) + [0, 0, 2.0], jnp.float32)
    )
    wi = vec.normalize(
        jnp.asarray(rng.normal(size=(n, 3)) + [0, 0, 2.0], jnp.float32)
    )
    u = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
    out = []
    for m in (m_const, m_tex):
        mats = _mats(m)
        p = beval.gather_lobes(mats, None, jnp.zeros((n,), jnp.int32))
        f = beval.bsdf_f(p, fr, wo, wi, BXDF_ALL)
        pdf = beval.bsdf_pdf(p, fr, wo, wi, BXDF_ALL)
        nc = beval.num_components(p, BXDF_ALL)
        bs = beval.bsdf_sample(p, fr, wo, u, BXDF_ALL)
        out.append((f, pdf, nc, bs))
    (f0, p0, n0, b0), (f1, p1, n1, b1) = out
    np.testing.assert_array_equal(np.asarray(n0), np.asarray(n1))
    np.testing.assert_allclose(np.asarray(f0), np.asarray(f1), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p1), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(np.asarray(b0.f), np.asarray(b1.f), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(b0.wi_world), np.asarray(b1.wi_world), rtol=5e-5, atol=5e-5
    )
    np.testing.assert_allclose(np.asarray(b0.pdf), np.asarray(b1.pdf), rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(
        np.asarray(b0.sampled_flags), np.asarray(b1.sampled_flags)
    )


def test_textured_assembly_matches_constant_recipe():
    _compare(thin=False)


def test_textured_assembly_matches_constant_recipe_thin():
    _compare(thin=True)


def test_textured_assembly_gates():
    # metallic=1 -> diffuse_weight=0 -> diffuse/retro/sheen disabled;
    # clearcoat=0 and spec_trans=0 disable their lobes
    _compare(thin=False, metallic=1.0, clearcoat=0.0, spec_trans=0.0)
    _compare(thin=False, sheen=0.0)
    _compare(thin=True, metallic=1.0, clearcoat=0.0, spec_trans=0.0)


def test_textured_color_varies_per_hit():
    """A real image texture on disney color must vary the BSDF across
    hits with different UVs (the per-hit path, end to end through the
    loader)."""
    import json, os, shutil, tempfile

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 3}
    cfg["materials"] = [
        {
            "material_type": "DisneyMaterial",
            "material_name": "m",
            "color": "s_01",
            "roughness": 0.4,
        }
    ]
    for p in cfg["Aggregate"]["primitives"]:
        p["material_name"] = "m"
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    shutil.copy(os.path.join(SAMPLES, "s_01.png"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene
    from rs_ray_toy_tpu.render import render_job

    job = load_scene(path)
    from rs_ray_toy_tpu.integrators.common import SceneCtx

    ctx = SceneCtx(job.scene)
    assert bool(np.any(np.asarray(ctx.mats["is_disney_tex"])))
    assert ctx.uses_textures  # disney_base_tex alone must trigger tex eval

    # decisive check: gather the diffuse-lobe weight for two hits at
    # different texture coordinates — the textured color must differ
    rng = np.random.default_rng(5)
    o = jnp.asarray(
        np.stack(
            [np.full(48, 20.0), rng.uniform(-2.2, 2.2, 48), rng.uniform(1.8, 3.8, 48)],
            -1,
        ),
        jnp.float32,
    )
    d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32), (48, 3))
    hit = ctx.intersect(o, d, jnp.full((48,), 1e9, jnp.float32))
    si = ctx.surface(hit, o, d)
    got = np.asarray(hit.valid)
    assert got.sum() > 8
    params = ctx.shade_params(si)
    s0 = np.asarray(params["s0"])[got, 0, :]  # diffuse slot weight
    assert s0.std(axis=0).max() > 1e-3, "textured color did not vary per hit"

    # the end-to-end render of this scene lives in the slow tier
    # (test_textured_disney_render_end_to_end): compiling the jnp
    # wavefront textured-Disney pipeline alone is ~10 min on this box
    global _TEXTURED_JOB
    _TEXTURED_JOB = job


_TEXTURED_JOB = None


@pytest.mark.slow
def test_textured_disney_render_end_to_end():
    """End-to-end render of the textured-Disney scene (jnp wavefront +
    differentials path — outside the megakernel subset)."""
    from rs_ray_toy_tpu.render import render_job

    if _TEXTURED_JOB is None:
        test_textured_color_varies_per_hit()
    res = render_job(_TEXTURED_JOB, spp_override=2, pupil_samples=1 << 10,
                     seed=0)
    rgb = np.asarray(res["rgb_srgb_input"])
    assert np.isfinite(rgb).all() and rgb.max() > 0