"""Light sampling unit tests (lights/point.rs, diffuse.rs, infinite.rs)."""

import numpy as np
import jax.numpy as jnp

from rs_ray_toy_tpu.core import vec
from rs_ray_toy_tpu.core.transform import Transform
from rs_ray_toy_tpu.lights import lights as lmod
from rs_ray_toy_tpu.scene.loader import _build_env_map, _pack_lights
from rs_ray_toy_tpu.scene.types import (
    AREA_SHAPE_SPHERE,
    LIGHT_DIFFUSE_AREA,
    LIGHT_POINT,
)


class _Sph:
    def __init__(self, o2w, radius):
        self.o2w = o2w
        self.radius = radius


def _table(entries, envs=()):
    return _pack_lights(
        entries, np.zeros(3), 100.0, list(envs)
    )


def test_point_light_inverse_square():
    entries = [dict(kind=LIGHT_POINT, p=np.array([0.0, 0.0, 10.0]), emit=np.array([800.0, 0, 0]))]
    lights = _table(entries)
    p_ref = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]])
    idx = jnp.zeros(2, jnp.int32)
    u = jnp.full((2, 2), 0.5)
    ls = lmod.sample_li(lights, [], idx, p_ref, u)
    assert np.allclose(ls.li[:, 0], [800.0 / 100.0, 800.0 / 25.0], rtol=1e-5)
    assert np.allclose(ls.wi, [[0, 0, 1], [0, 0, 1]], atol=1e-6)
    assert np.allclose(ls.pdf, 1.0)


def test_area_light_sphere_sampling():
    o2w = Transform.translate([0.0, 0.0, 5.0]).m
    entries = [
        dict(
            kind=LIGHT_DIFFUSE_AREA,
            emit=np.array([2.0, 2.0, 2.0]),
            shape_kind=AREA_SHAPE_SPHERE,
            sphere=_Sph(o2w, 1.0),
            area=4 * np.pi,
        )
    ]
    lights = _table(entries)
    n = 2000
    rng = np.random.default_rng(0)
    p_ref = jnp.zeros((n, 3))
    idx = jnp.zeros(n, jnp.int32)
    u = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
    ls = lmod.sample_li(lights, [], idx, p_ref, u)
    # sampled points lie on the sphere surface
    d = np.linalg.norm(np.asarray(ls.p_light) - [0, 0, 5], axis=-1)
    assert np.allclose(d, 1.0, atol=1e-5)
    # one-sided: only front-facing samples emit
    lit = np.asarray(ls.li).sum(-1) > 0
    assert 0.2 < lit.mean() < 0.8
    # quirk pdf: dist^2/|cos| (no area term)
    p = np.asarray(ls.p_light)
    wi = np.asarray(ls.wi)
    nrm = (p - [0, 0, 5]) / 1.0
    cos = np.abs((-wi * nrm).sum(-1))
    want = (p**2).sum(-1) / np.maximum(cos, 1e-9)
    # f32 silhouette samples (cos -> 0) amplify rounding; compare away from
    # the silhouette
    solid = cos > 0.05
    assert np.allclose(np.asarray(ls.pdf)[solid], want[solid], rtol=5e-3)


def test_env_light_sampling_prefers_bright_texels():
    import tempfile, os

    from rs_ray_toy_tpu.utils.png import write_png

    img = np.zeros((16, 32, 3), np.uint8)
    img[4, 20] = 255  # one bright texel
    with tempfile.TemporaryDirectory() as td:
        pth = os.path.join(td, "env.png")
        write_png(pth, img)
        env = _build_env_map(pth, Transform())
    entries = [
        dict(kind=3, emit=np.ones(3), env_id=0),
    ]
    lights = _table(entries, envs=[env])
    n = 4000
    rng = np.random.default_rng(1)
    p_ref = jnp.zeros((n, 3))
    idx = jnp.zeros(n, jnp.int32)
    u = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
    ls = lmod.sample_li(lights, [env], idx, p_ref, u)
    # directions should concentrate in one cluster; li nonzero where sampled
    assert float(jnp.mean(jnp.max(ls.li, axis=-1) > 0.1)) > 0.9
    mean_dir = np.asarray(ls.wi).mean(0)
    assert np.linalg.norm(mean_dir) > 0.8  # strongly clustered
    # pdf_li at sampled directions roughly matches sample pdf
    pdfs = lmod.pdf_li(lights, [env], idx, p_ref, ls.wi)
    ok = np.asarray(ls.pdf) > 0
    ratio = np.asarray(pdfs)[ok] / np.asarray(ls.pdf)[ok]
    assert np.median(np.abs(ratio - 1.0)) < 0.2


def test_le_escape_uses_only_infinite_section():
    from rs_ray_toy_tpu.lights.lights import le_escape

    env = _build_env_map("", Transform())  # white 8x8 dummy
    env["escape_le"] = True
    d = jnp.asarray(np.random.default_rng(2).normal(size=(10, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    out = le_escape([env], d)
    assert np.all(np.asarray(out) > 0.5)  # white map everywhere
    env2 = dict(env)
    env2["escape_le"] = False
    out2 = le_escape([env2], d)
    assert np.all(np.asarray(out2) == 0.0)


def test_bump_mapping_perturbs_normals():
    import jax.numpy as jnp
    from rs_ray_toy_tpu.scene import textures as tex
    from rs_ray_toy_tpu.scene.loader import SceneBundle
    from rs_ray_toy_tpu.bsdf.lobes import MaterialTableBuilder
    from rs_ray_toy_tpu.bsdf import recipes
    from rs_ray_toy_tpu.bsdf.recipes import FloatParam, RGBParam
    from rs_ray_toy_tpu.integrators.common import SceneCtx
    from rs_ray_toy_tpu.scene.types import empty_triangles, empty_spheres
    from rs_ray_toy_tpu.accel.geometry import SurfaceHit

    reg = tex.TextureRegistry()
    wid = reg.add(tex.TexRecord(kind=tex.TEX_WINDY, is_rgb=False))
    b = MaterialTableBuilder()
    m = recipes.matte("bumpy", RGBParam(np.ones(3) * 0.5), FloatParam(0.0), bump_tex=wid)
    b.add(m)
    bundle = SceneBundle(
        triangles=empty_triangles(), spheres=empty_spheres(),
        lights=_table([dict(kind=LIGHT_POINT, p=np.zeros(3), emit=np.ones(3))]),
        materials=b.pack(), registry=reg, dev_images=[], infinite=[],
        world_bound=np.array([[0.0,0,0],[1,1,1]]), max_prims_in_node=4,
    )
    ctx = SceneCtx(bundle)
    n = 16
    rng = np.random.default_rng(4)
    z3 = jnp.zeros((n, 3))
    si = SurfaceHit(
        p=jnp.asarray(rng.uniform(0, 5, size=(n, 3)), jnp.float32),
        ng=z3.at[:, 2].set(1.0), ns=z3.at[:, 2].set(1.0),
        uv=jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32),
        dpdu=z3.at[:, 0].set(1.0), dpdv=z3.at[:, 1].set(1.0),
        wo=z3.at[:, 2].set(1.0),
        mat=jnp.zeros(n, jnp.int32), area_light=jnp.full(n, -1, jnp.int32),
        valid=jnp.ones(n, bool),
    )
    si2 = ctx.apply_bump(si)
    ns = np.asarray(si2.ns)
    assert np.allclose(np.linalg.norm(ns, axis=-1), 1.0, atol=1e-5)
    # windy noise is nonconstant -> most normals tilt away from +z
    assert (np.abs(ns[:, 2] - 1.0) > 1e-6).mean() > 0.5
