"""The base scene is generated from constants: samples/ is its output."""

import json
import os

import jax
import numpy as np

from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR, write_base_scene
from rs_ray_toy_tpu.scene.loader import load_scene


def test_write_base_scene_matches_committed_samples(tmp_path):
    write_base_scene(str(tmp_path))
    for name in ("scene.json", "cube.obj", "s_01.png"):
        with open(os.path.join(SAMPLES_DIR, name), "rb") as fh:
            want = fh.read()
        with open(tmp_path / name, "rb") as fh:
            assert fh.read() == want, name


def test_base_scene_contents():
    job = load_scene(os.path.join(SAMPLES_DIR, "scene.json"))
    assert (job.film.xres, job.film.yres) == (640, 360)
    assert job.integrator.kind == "debug"
    assert job.sampler.kind == "stratified" and job.sampler.spp == 16
    assert int(job.scene.triangles.count) == 3 * 12
    assert int(job.scene.lights.count) == 3
    # white, pink and cyan point lights
    emit = np.asarray(job.scene.lights.emit)
    assert emit[0][0] == emit[0][1] == emit[0][2]
    assert emit[1][0] > emit[1][1] and emit[2][2] > emit[2][0]
    # every name the tests and bench.py build on
    with open(os.path.join(SAMPLES_DIR, "scene.json")) as fh:
        cfg = json.load(fh)
    names = {m["material_name"] for m in cfg["materials"]}
    assert {"mat_matte", "mat_plastic", "mat_metal"} <= names
    assert [t["texture_name"] for t in cfg["rgb_texture"]] == ["s_01"]


def test_base_scene_lens_focuses_at_the_cubes():
    from rs_ray_toy_tpu.camera.realistic import (
        build_lens_system,
        focus_thick_lens,
    )

    job = load_scene(os.path.join(SAMPLES_DIR, "scene.json"))
    lens = build_lens_system(job.camera.lens_data, job.camera.aperture_diameter)
    rear = focus_thick_lens(lens, 35.0, job.film.diagonal_mm * 0.001)
    # a 50 mm lens focused at 35 m sits just behind its focal length
    assert 0.0 < rear < 0.1


def test_scene_tables_are_pytrees():
    job = load_scene(os.path.join(SAMPLES_DIR, "scene.json"))
    for table in (job.scene.triangles, job.scene.spheres, job.scene.lights):
        leaves, treedef = jax.tree_util.tree_flatten(table)
        assert len(leaves) == len(type(table).__dataclass_fields__)
        back = jax.tree_util.tree_unflatten(treedef, leaves)
        assert type(back) is type(table)
        doubled = jax.jit(lambda t: jax.tree_util.tree_map(lambda x: x, t))(
            table
        )
        for a, b in zip(jax.tree_util.tree_leaves(doubled), leaves):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
