"""Checkpoint/resume equivalence (SURVEY §5: film + sampler counters are
pure arrays — a resumed render must reproduce the uninterrupted one
exactly, on the all-pairs path and on BVH scenes)."""

import json
import os
import shutil
import tempfile

import numpy as np

from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR as SAMPLES


def _scene(path_dir):
    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    # depth 2 keeps the fast tier quick (the test pins resume cursor
    # arithmetic, not transport depth)
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 2}
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), path_dir)
    p = os.path.join(path_dir, "s.json")
    json.dump(cfg, open(p, "w"))
    return p


def test_checkpoint_resume_bitexact():
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.loader import load_scene

    td = tempfile.mkdtemp()
    p = _scene(td)
    ck = os.path.join(td, "ck.npz")

    full = np.asarray(
        render_job(
            load_scene(p), spp_override=2, pupil_samples=1 << 10, seed=0
        )["rgb_srgb_input"]
    )
    render_job(
        load_scene(p), spp_override=2, stop_at_spp=1,
        pupil_samples=1 << 10, seed=0, checkpoint_to=ck,
    )
    resumed = np.asarray(
        render_job(
            load_scene(p), spp_override=2, pupil_samples=1 << 10, seed=0,
            resume_from=ck,
        )["rgb_srgb_input"]
    )
    np.testing.assert_array_equal(full, resumed)


def test_checkpoint_resume_bvh_scene():
    """A 432-triangle grid renders through BVH traversal; resuming it from
    a checkpoint reproduces the uninterrupted render."""
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.gen import write_grid_scene
    from rs_ray_toy_tpu.scene.loader import load_scene

    td = tempfile.mkdtemp()
    p = write_grid_scene(td, ny=6, nz=6, xres=48, yres=32, max_depth=2)
    ck = os.path.join(td, "ck.npz")

    full = np.asarray(
        render_job(
            load_scene(p), spp_override=2, pupil_samples=1 << 10, seed=0
        )["rgb_srgb_input"]
    )
    render_job(
        load_scene(p), spp_override=2, stop_at_spp=1,
        pupil_samples=1 << 10, seed=0, checkpoint_to=ck,
    )
    resumed = np.asarray(
        render_job(
            load_scene(p), spp_override=2, pupil_samples=1 << 10, seed=0,
            resume_from=ck,
        )["rgb_srgb_input"]
    )
    np.testing.assert_array_equal(full, resumed)
