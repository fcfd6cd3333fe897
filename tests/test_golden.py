"""Golden-image regression tests (SURVEY §4 tier 3 stand-in).

The Rust reference can't run here (no rustc), so these goldens lock OUR
estimator against accidental drift: tiny deterministic renders compared to
stored arrays.  Regenerate intentionally with REGEN_GOLDEN=1 when an
estimator change is *meant* to shift radiance, and say why in the commit.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR as SAMPLES


def _tiny_job(integrator="debug", **integ_kw):
    import json, shutil, tempfile

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    mapping = {"debug": "Debug", "path": "Path", "direct": "DirectLighting"}
    cfg["Integrator"] = {"integrator_type": mapping[integrator], **integ_kw}
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    return load_scene(path)


def _render(job, spp):
    from rs_ray_toy_tpu.render import render_job

    res = render_job(job, spp_override=spp, pupil_samples=1 << 10, seed=0)
    return np.asarray(res["rgb_srgb_input"])


def _check(name, rgb):
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    path = os.path.join(GOLDEN_DIR, f"{name}.npy")
    if os.environ.get("REGEN_GOLDEN") or not os.path.exists(path):
        np.save(path, rgb)
        if not os.environ.get("REGEN_GOLDEN"):
            pytest.skip(f"golden {name} created; rerun to compare")
        return
    want = np.load(path)
    rmse = float(np.sqrt(np.mean((rgb - want) ** 2)))
    assert rmse < 1e-4, f"golden {name} drifted: rmse {rmse}"


def test_golden_debug():
    _check("debug_40x24_2spp", _render(_tiny_job("debug", max_depth=3), 2))


def test_golden_path():
    _check("path_40x24_2spp", _render(_tiny_job("path", max_depth=4), 2))


def test_golden_direct_all():
    _check(
        "direct_40x24_2spp",
        _render(_tiny_job("direct", max_depth=3, light_strategy="all"), 2),
    )


def _sphere_area_job():
    import json, shutil, tempfile

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 3}
    cfg["Aggregate"]["primitives"] = [
        {
            "primitive_type": "sphere",
            "material_name": "mat_matte",
            "radius": 2.0,
            "world_pos": [35.2, 0.0, 0.0],
        }
    ]
    cfg["lights"].append(
        {
            "light_type": "diffuse",
            "spectrum": {"values": [20, 20, 20]},
            "light_shape": {
                "shape_type": "sphere",
                "radius": 1.0,
                "world_pos": [35.2, 6.0, 0.0],
            },
        }
    )
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    return load_scene(path)


def test_golden_sphere_arealight_path():
    rgb = _render(_sphere_area_job(), 2)
    assert np.isfinite(rgb).all() and rgb.max() > 0
    _check("sphere_area_40x24_2spp", rgb)


def _material_job(material, max_depth=4):
    import json, shutil, tempfile

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": max_depth}
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = material
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    return load_scene(path)


def test_golden_plastic_path():
    """Drift guard for the microfacet (TR dielectric) jnp path."""
    _check("plastic_40x24_2spp", _render(_material_job("mat_plastic"), 2))


def test_golden_metal_path():
    """Drift guard for the conductor-fresnel microfacet jnp path."""
    _check("metal_40x24_2spp", _render(_material_job("mat_metal"), 2))


def _halton_job():
    import json, shutil, tempfile

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 4}
    cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": 4}
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    return load_scene(path)


def test_golden_halton_path():
    """Drift guard for the Halton sampler driving the path integrator
    (halton.rs is the reference Path config's low-discrepancy sampler)."""
    job = _halton_job()
    assert job.sampler.kind == "halton"
    rgb = _render(job, 4)
    assert np.isfinite(rgb).all() and rgb.max() > 0
    _check("halton_path_40x24_4spp", rgb)
