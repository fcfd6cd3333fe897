"""Film accumulation: own-pixel scatter for box filters, footprint splats
for wider ones."""

import numpy as np
import jax.numpy as jnp

from rs_ray_toy_tpu.film import film as fmod
from rs_ray_toy_tpu.scene.loader import FilmSpec


def _spec(w=5, h=3, ftype="BoxFilter", radius=0.5):
    return FilmSpec(
        xres=w, yres=h, diagonal_mm=35.0, scale=1.0,
        max_sample_luminance=float("inf"), filter_type=ftype,
        filter_radius=np.array([radius, radius]),
    )


def _batch(w, h, k, seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    xy = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (k, 1)).astype(np.float32)
    pid = np.tile((ys * w + xs).ravel(), k)
    u = rng.random(xy.shape).astype(np.float32)
    # a jitter that rounds onto the next pixel's edge in float32
    u[3] = [np.nextafter(np.float32(1.0), np.float32(0.0))] * 2
    p_edge = np.float32(1000.0) + u[3, 0]  # rounds to 1001.0 in float32
    assert p_edge == np.float32(1001.0)
    p = jnp.asarray(xy + u)
    rad = jnp.asarray(rng.random((xy.shape[0], 3)), jnp.float32)
    wt = jnp.asarray(rng.random(xy.shape[0]), jnp.float32)
    return p, rad, wt, jnp.asarray(pid, jnp.uint32)


def test_pixel_id_path_matches_aligned_path():
    """A batch laid out as the pixel grid k times over: the pixel-id
    scatter equals the per-pixel sum of the k samples (the reshape-add
    of the grid-aligned layout), including a sample whose raster
    position rounded onto the next pixel's edge."""
    from rs_ray_toy_tpu.core.spectrum import rgb_to_xyz

    spec = _spec()
    p, rad, wt, pid = _batch(5, 3, k=2)
    film = fmod.add_samples(fmod.make_film(spec), spec, p, rad, wt, pixel_id=pid)
    contrib = np.asarray(rgb_to_xyz(rad)) * np.asarray(wt)[:, None]
    want_xyz = contrib.reshape(2, 3, 5, 3).sum(axis=0)
    np.testing.assert_array_equal(np.asarray(film.weight), np.full((3, 5), 2.0))
    np.testing.assert_allclose(np.asarray(film.xyz), want_xyz, rtol=1e-6)


def test_pixel_id_path_drops_padded_lanes():
    spec = _spec()
    p, rad, wt, pid = _batch(5, 3, k=1)
    valid = jnp.arange(pid.shape[0]) < 10
    film = fmod.add_samples(
        fmod.make_film(spec), spec, p, rad, wt, pixel_id=pid, valid=valid
    )
    w = np.asarray(film.weight).ravel()
    assert w[:10].sum() == 10.0 and w[10:].sum() == 0.0
    assert np.all(np.asarray(film.xyz).reshape(-1, 3)[10:] == 0.0)


def test_wide_filter_splats_over_neighbours():
    spec = _spec(ftype="TriangleFilter", radius=2.0)
    p = jnp.asarray([[2.5, 1.5]], jnp.float32)  # centre of pixel (2, 1)
    film = fmod.add_samples(
        fmod.make_film(spec), spec, p, jnp.ones((1, 3)), jnp.ones((1,)),
        pixel_id=jnp.asarray([7], jnp.uint32),
    )
    w = np.asarray(film.weight)
    assert w[1, 2] == w.max() and (w > 0).sum() > 1
