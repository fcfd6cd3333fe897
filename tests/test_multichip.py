"""Sharded rendering correctness: render_job over a shard_map DP mesh with
a psum film must reproduce the single-device film.  Counter-based
sampling makes every ray the same on both, so this is a per-value
comparison to a few float32 ulps, not a statistical one."""

import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import jax

from tests.test_golden import SAMPLES


def _setup(xres=32, yres=16, max_depth=2):
    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = xres, yres
    cfg["Integrator"] = {"integrator_type": "Debug", "max_depth": max_depth}
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    return load_scene(path)


def _render_pair(job_fn, n_dev=8, spp=4):
    """The same job rendered on one device and over an n_dev 'dp' mesh
    through render_job, the deploy_render(n_devices=N) code path."""
    from rs_ray_toy_tpu.parallel.mesh import make_mesh
    from rs_ray_toy_tpu.render import render_job

    assert len(jax.devices()) >= n_dev, "conftest should provide 8 cpu devices"
    single = render_job(job_fn(), spp_override=spp, pupil_samples=1 << 10)
    multi = render_job(
        job_fn(), spp_override=spp, pupil_samples=1 << 10,
        mesh=make_mesh(n_dev),
    )
    return single["film"], multi["film"]


def _assert_films_close(single, multi, box):
    """Per value: radiance to a relative 1e-5 with a floor of 1e-7 (each
    shard's batch may compile with other fused multiply-adds); filter
    weights bit-equal for a box filter, where every sample lands on its
    own pixel, else to a relative 1e-6 (the psum adds a pixel's
    footprint contributions from several devices in another order)."""
    a, b = np.asarray(single.xyz), np.asarray(multi.xyz)
    assert a.shape == b.shape and a.max() > 0.0
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    wa, wb = np.asarray(single.weight), np.asarray(multi.weight)
    if box:
        np.testing.assert_array_equal(wb, wa)
    else:
        np.testing.assert_allclose(wb, wa, rtol=1e-6, atol=1e-7)


def test_sharded_matches_single_device():
    """A wide triangle filter under the mesh: every sample splats over a
    5x5 footprint that crosses shard boundaries, so the psum must merge
    partial pixels from several devices."""
    def job():
        j = _setup(max_depth=2)
        j.film.filter_type = "TriangleFilter"
        j.film.filter_radius = np.array([2.0, 2.0])
        return j

    single, multi = _render_pair(job)
    _assert_films_close(single, multi, box=False)


def test_sharded_nondivisible_batch_matches_single_device():
    """33x5 = 165 pixels on 8 devices: padded lanes must contribute zero
    filter weight (round-1 advisor finding: pad lanes accumulated box
    filter weight at pixel (0,0))."""
    single, multi = _render_pair(lambda: _setup(xres=33, yres=5))
    _assert_films_close(single, multi, box=True)
    assert np.asarray(multi.weight).sum() == 165 * 4


def test_dryrun_multichip_entry_point():
    """The driver-facing entry point must pass on an 8-CPU-device mesh
    (round-1 MULTICHIP artifact was ok=false: the entry point did not
    force the CPU platform).  Here jax is already imported CPU-side, so
    the in-process path runs."""
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def _setup_kind(kind, xres=32, yres=16, max_depth=2):
    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = xres, yres
    cfg["Integrator"] = {"integrator_type": kind, "max_depth": max_depth}
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    return load_scene(path)


def test_render_job_mesh_sppm_raises():
    """SPPM renders on one device: a multi-device mesh is refused with a
    clear error instead of quietly rendering on one device."""
    from rs_ray_toy_tpu.parallel.mesh import make_mesh
    from rs_ray_toy_tpu.render import render_job

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 32, 16
    cfg["Integrator"] = {
        "integrator_type": "SPPM", "radius": 1.0, "n_iters": 2,
        "max_depth": 3, "photons_per_iter": 1024,
    }
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene

    with pytest.raises(NotImplementedError, match="single device"):
        render_job(load_scene(path), mesh=make_mesh(8))


def test_render_job_mesh_matches_single_device():
    """The PRODUCTION multi-device path: render_job(mesh=) must reproduce
    the single-device render for Debug and Path — the
    deploy_render(n_devices=N) code path, not a test harness."""
    for kind in ("Debug", "Path"):
        single, multi = _render_pair(lambda: _setup_kind(kind))
        _assert_films_close(single, multi, box=True)
