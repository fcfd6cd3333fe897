"""Specular-chain ray-differential tests (integrator/mod.rs:150-301,
interaction.rs:223-284, triangle.rs:351-386, sphere.rs:215-243).

On a flat surface (dndu = dndv = 0) the reflected differential directions
reduce exactly to mirror reflections of the incoming differential
directions — an analytic identity of the PBRT formula.  Degenerate
(dead) differentials must propagate to the child main direction.
"""

import numpy as np

from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR as SAMPLES
import jax.numpy as jnp

from rs_ray_toy_tpu.accel import geometry as geom
from rs_ray_toy_tpu.core import vec


def _flat_si(n, ns):
    z3 = jnp.zeros((n, 3), jnp.float32)
    nsb = jnp.broadcast_to(jnp.asarray(ns, jnp.float32), (n, 3))
    return geom.SurfaceHit(
        p=z3,
        ng=nsb,
        ns=nsb,
        uv=jnp.zeros((n, 2), jnp.float32),
        dpdu=jnp.broadcast_to(jnp.asarray([1.0, 0, 0], jnp.float32), (n, 3)),
        dpdv=jnp.broadcast_to(jnp.asarray([0, 0, 1.0], jnp.float32), (n, 3)),
        wo=None,  # set by caller
        mat=jnp.zeros((n,), jnp.int32),
        area_light=jnp.full((n,), -1, jnp.int32),
        valid=jnp.ones((n,), bool),
        dndu=z3,
        dndv=z3,
    )


def test_flat_reflect_differentials_are_mirror_reflections():
    n = 16
    rng = np.random.default_rng(0)
    ns = np.asarray([0.0, 1.0, 0.0])
    # incoming main dirs from above (y<0 component)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    wo = -d
    si = _flat_si(n, ns)._replace(wo=wo)

    # slightly perturbed differential dirs
    rx_d = vec.normalize(d + jnp.asarray(rng.normal(size=(n, 3)) * 0.01, jnp.float32))
    ry_d = vec.normalize(d + jnp.asarray(rng.normal(size=(n, 3)) * 0.01, jnp.float32))
    diff = (jnp.zeros((n, 3), jnp.float32), rx_d, jnp.zeros((n, 3), jnp.float32), ry_d)

    nsb = jnp.broadcast_to(jnp.asarray(ns, jnp.float32), (n, 3))
    wi = d - 2.0 * vec.dot(d, nsb)[:, None] * nsb  # main mirror reflection
    duv = jnp.zeros((n, 4), jnp.float32)
    dpdx = dpdy = jnp.zeros((n, 3), jnp.float32)
    _, new_rx_d, _, new_ry_d = geom.specular_reflect_differentials(
        si, duv, dpdx, dpdy, diff, wi
    )
    want_rx = rx_d - 2.0 * vec.dot(rx_d, nsb)[:, None] * nsb
    want_ry = ry_d - 2.0 * vec.dot(ry_d, nsb)[:, None] * nsb
    np.testing.assert_allclose(np.asarray(new_rx_d), np.asarray(want_rx), atol=1e-6)
    np.testing.assert_allclose(np.asarray(new_ry_d), np.asarray(want_ry), atol=1e-6)


def test_dead_differentials_stay_dead():
    """diff == main ray => child differential dirs == wi (both modes)."""
    n = 8
    rng = np.random.default_rng(1)
    ns = np.asarray([0.0, 1.0, 0.0])
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    wo = -d
    si = _flat_si(n, ns)._replace(wo=wo)
    diff = geom.dead_differentials(jnp.zeros((n, 3), jnp.float32), d)
    duv = jnp.zeros((n, 4), jnp.float32)
    z = jnp.zeros((n, 3), jnp.float32)

    wi_r = d - 2.0 * vec.dot(d, si.ns)[:, None] * si.ns
    _, rx_r, _, ry_r = geom.specular_reflect_differentials(si, duv, z, z, diff, wi_r)
    np.testing.assert_allclose(np.asarray(rx_r), np.asarray(wi_r), atol=1e-6)

    # transmit: refract the main dir with eta=1.5 (entering)
    eta = 1.0 / 1.5
    cos_i = np.asarray(vec.dot(wo, si.ns))
    sin2_t = eta * eta * (1.0 - cos_i**2)
    cos_t = np.sqrt(1.0 - sin2_t)
    wi_t = jnp.asarray(
        -eta * np.asarray(wo) + (eta * cos_i - cos_t)[:, None] * np.asarray(si.ns),
        jnp.float32,
    )
    _, rx_t, _, ry_t = geom.specular_transmit_differentials(
        si, duv, z, z, diff, wi_t, jnp.full((n,), 1.5, jnp.float32)
    )
    np.testing.assert_allclose(np.asarray(rx_t), np.asarray(wi_t), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ry_t), np.asarray(wi_t), atol=1e-6)


def test_sphere_dndu_matches_finite_difference():
    """Sphere shading-normal partials: compare dndu/dndv from
    surface_interaction against finite differences of the normal along
    the parametric directions."""
    import json, shutil, tempfile, os

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["materials"] = [
        {"material_type": "MatteMaterial", "material_name": "m"}
    ]
    cfg["Aggregate"]["primitives"] = [
        {
            "primitive_type": "sphere",
            "material_name": "m",
            "radius": 2.0,
            "world_pos": [0.0, 0.0, 0.0],
        }
    ]
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    p = os.path.join(td, "s.json")
    json.dump(cfg, open(p, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene
    from rs_ray_toy_tpu.integrators.common import SceneCtx

    ctx = SceneCtx(load_scene(p).scene)
    n = 32
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = jnp.asarray(dirs * 10.0, jnp.float32)
    d = jnp.asarray(-dirs, jnp.float32)
    hit = ctx.intersect(o, d, jnp.full((n,), 1e9, jnp.float32))
    si = ctx.surface(hit, o, d)
    assert bool(jnp.all(hit.valid))

    # for a radius-2 sphere at origin: n = p/2, so dn/du must equal
    # dpdu/2 and dn/dv dpdv/2
    np.testing.assert_allclose(
        np.asarray(si.dndu), np.asarray(si.dpdu) / 2.0, atol=1e-4, rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(si.dndv), np.asarray(si.dpdv) / 2.0, atol=1e-4, rtol=1e-4
    )


def test_triangle_flat_mesh_dnd_zero():
    """cube.obj vertex normals equal face normals per face -> dndu/dndv
    are well-defined but the footprint math must stay finite; flat
    (has_n=0) meshes must produce exactly zero."""
    import json, shutil, tempfile, os

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    p = os.path.join(td, "s.json")
    json.dump(cfg, open(p, "w"))
    from rs_ray_toy_tpu.scene.loader import load_scene
    from rs_ray_toy_tpu.integrators.common import SceneCtx

    ctx = SceneCtx(load_scene(p).scene)
    # parallel ray grid aimed straight at the cube at (35.2, -1.3, 0.4)
    ys, zs = np.mgrid[-1.9:-0.7:8j, -0.2:1.0:8j]
    n = ys.size
    o = jnp.asarray(
        np.stack([np.full(n, 20.0), ys.ravel(), zs.ravel()], -1), jnp.float32
    )
    d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32), (n, 3))
    hit = ctx.intersect(o, d, jnp.full((n,), 1e9, jnp.float32))
    si = ctx.surface(hit, o, d)
    got = np.asarray(hit.valid)
    assert got.sum() > 8
    # cube.obj's per-face vn equal the face normal: the shading normal
    # field is constant per face, so dndu = dndv = 0
    np.testing.assert_allclose(np.asarray(si.dndu)[got], 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(si.dndv)[got], 0.0, atol=1e-5)
