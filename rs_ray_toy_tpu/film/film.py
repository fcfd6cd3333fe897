"""Film: XYZ accumulation as device arrays + filtered scatter-add splats.

The reference's Film (film.rs) keeps a RwLock'd Pixel vec merged from
per-tile buffers; here the film is three device arrays
  xyz: (H, W, 3), weight: (H, W), splat_xyz: (H, W, 3)
and FilmTile::add_sample (film.rs:77-130) becomes a scatter-add over the
static filter footprint: for a filter radius r the footprint is a fixed
(2*ceil(r)+1)^2 grid of pixel offsets, each added with `.at[].add()` —
XLA lowers this to on-device scatters, and across a device mesh the film
merge is a `psum` instead of merge_film_tile's lock.

The 16x16 filter-weight table quirk (film.rs:169-170 writes p.x twice, so
the table is effectively 1-D in y) is *fixed* here: we evaluate the true
2-D filter at exact offsets (no table quantization at all, and no table
gather).
"""

import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE
from ..core.spectrum import gamma_correct, luminance, rgb_to_xyz, xyz_to_rgb
from ..scene.loader import FilmSpec


class FilmState(NamedTuple):
    xyz: jnp.ndarray  # (H,W,3)
    weight: jnp.ndarray  # (H,W)
    splat_xyz: jnp.ndarray  # (H,W,3)


def make_film(spec: FilmSpec) -> FilmState:
    h, w = spec.yres, spec.xres
    return FilmState(
        xyz=jnp.zeros((h, w, 3), DTYPE),
        weight=jnp.zeros((h, w), DTYPE),
        splat_xyz=jnp.zeros((h, w, 3), DTYPE),
    )


def _filter_eval(spec: FilmSpec, dx, dy):
    """Evaluate the reconstruction filter at continuous offsets.

    Box (filters/boxfilter.rs): 1 inside the radius.
    Triangle (filters/trianglefilter.rs): max(0, r-|x|)*max(0, r-|y|).
    Gaussian (filters/gaussian.rs): (e^{-a x^2}-e^{-a r^2})+ per axis.
    """
    rx, ry = float(spec.filter_radius[0]), float(spec.filter_radius[1])
    inside = (jnp.abs(dx) <= rx) & (jnp.abs(dy) <= ry)
    if spec.filter_type == "TriangleFilter":
        w = jnp.maximum(0.0, rx - jnp.abs(dx)) * jnp.maximum(0.0, ry - jnp.abs(dy))
    elif spec.filter_type == "GaussianFilter":
        a = spec.gaussian_alpha
        gx = jnp.maximum(0.0, jnp.exp(-a * dx * dx) - math.exp(-a * rx * rx))
        gy = jnp.maximum(0.0, jnp.exp(-a * dy * dy) - math.exp(-a * ry * ry))
        w = gx * gy
    else:
        w = jnp.ones_like(dx)
    return jnp.where(inside, w, 0.0)


def add_samples(
    film: FilmState, spec: FilmSpec, p_film, radiance, sample_weight,
    pixel_id=None, valid=None,
):
    """FilmTile::add_sample batched (film.rs:77-130).

    p_film: (N,2) raster positions; radiance: (N,3) RGB; sample_weight: (N,)
    camera-ray weights.  Returns updated FilmState.

    With a box filter of radius <= 0.5 every sample lands on its own pixel.
    Given pixel_id, the (N,) flat pixel index each sample was drawn for
    (valid: (N,) mask of real samples), such samples are scatter-added
    onto that pixel, which is right even for a sample whose float32
    raster position rounded onto the next pixel's edge.

    Otherwise each sample is splatted over the filter footprint around
    its raster position.
    """
    h, w = film.weight.shape
    rx, ry = float(spec.filter_radius[0]), float(spec.filter_radius[1])
    own_pixel = spec.filter_type == "BoxFilter" and rx <= 0.5 and ry <= 0.5
    # luminance clamp (film.rs:83-85)
    if np.isfinite(spec.max_sample_luminance):
        y = luminance(radiance)
        scale = jnp.where(
            y > spec.max_sample_luminance,
            spec.max_sample_luminance / jnp.maximum(y, 1e-20),
            1.0,
        )
        radiance = radiance * scale[..., None]
    contrib = rgb_to_xyz(radiance) * sample_weight[..., None]

    if own_pixel and pixel_id is not None:
        fw = jnp.ones(pixel_id.shape, DTYPE) if valid is None else valid.astype(DTYPE)
        idx = pixel_id.astype(jnp.int32)
        xyz = film.xyz.reshape(h * w, 3).at[idx].add(contrib * fw[..., None])
        wt = film.weight.reshape(h * w).at[idx].add(fw)
        return FilmState(
            xyz=xyz.reshape(h, w, 3),
            weight=wt.reshape(h, w),
            splat_xyz=film.splat_xyz,
        )

    pdx = p_film[..., 0] - 0.5
    pdy = p_film[..., 1] - 0.5
    # static footprint: every pixel with |px - pd| <= r
    span_x = range(-int(math.ceil(rx - 0.5)), int(math.ceil(rx - 0.5)) + 1) if rx > 0.5 else (0,)
    span_y = range(-int(math.ceil(ry - 0.5)), int(math.ceil(ry - 0.5)) + 1) if ry > 0.5 else (0,)

    base_x = jnp.round(pdx).astype(jnp.int32)
    base_y = jnp.round(pdy).astype(jnp.int32)

    new_xyz = film.xyz
    new_wt = film.weight
    for oy in span_y:
        for ox in span_x:
            px = base_x + ox
            py = base_y + oy
            fw = _filter_eval(spec, px.astype(DTYPE) - pdx, py.astype(DTYPE) - pdy)
            ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            fw = jnp.where(ok, fw, 0.0)
            pxc = jnp.clip(px, 0, w - 1)
            pyc = jnp.clip(py, 0, h - 1)
            new_xyz = new_xyz.at[pyc, pxc].add(contrib * fw[..., None])
            new_wt = new_wt.at[pyc, pxc].add(fw)
    return FilmState(xyz=new_xyz, weight=new_wt, splat_xyz=film.splat_xyz)


def add_splats(film: FilmState, spec: FilmSpec, p_film, radiance):
    """Film::add_splat batched (film.rs:280-321): nearest pixel, no filter,
    NaN/negative/infinite scrubbed."""
    h, w = film.weight.shape
    y = luminance(radiance)
    ok = jnp.isfinite(y) & (y >= 0.0) & jnp.all(jnp.isfinite(radiance), axis=-1)
    if np.isfinite(spec.max_sample_luminance):
        scale = jnp.where(
            y > spec.max_sample_luminance,
            spec.max_sample_luminance / jnp.maximum(y, 1e-20),
            1.0,
        )
        radiance = radiance * scale[..., None]
    px = jnp.floor(p_film[..., 0]).astype(jnp.int32)
    py = jnp.floor(p_film[..., 1]).astype(jnp.int32)
    ok &= (px >= 0) & (px < w) & (py >= 0) & (py < h)
    xyz = rgb_to_xyz(radiance) * ok[..., None]
    return film._replace(
        splat_xyz=film.splat_xyz.at[jnp.clip(py, 0, h - 1), jnp.clip(px, 0, w - 1)].add(
            xyz
        )
    )


def set_image(film: FilmState, rgb):
    """Film::set_image (film.rs:265-278): xyz set, weight=1, splats cleared."""
    return FilmState(
        xyz=rgb_to_xyz(rgb),
        weight=jnp.ones_like(film.weight),
        splat_xyz=jnp.zeros_like(film.splat_xyz),
    )


def to_rgb(film: FilmState, spec: FilmSpec, splat_scale=1.0):
    """Film::write_image math (film.rs:323-361): normalize by filter weight,
    add splats, apply scale.  Returns (H,W,3) linear RGB."""
    rgb = xyz_to_rgb(film.xyz)
    wt = film.weight[..., None]
    rgb = jnp.where(wt != 0.0, jnp.maximum(rgb / jnp.where(wt == 0, 1.0, wt), 0.0), rgb)
    rgb = rgb + splat_scale * xyz_to_rgb(film.splat_xyz)
    return rgb * spec.scale


def write_png(rgb, path):
    """8-bit sRGB PNG (renderprocess.rs:1501-1530 gamma+clamp semantics)."""
    from ..utils.png import write_png as _write

    arr = np.asarray(gamma_correct(jnp.asarray(rgb)))
    q = np.clip(255.0 * arr + 0.5, 0.0, 255.0).astype(np.uint8)
    _write(path, q)
    colored = int(np.sum(q.sum(axis=-1) > 0))
    return colored
