"""Sampling warps and distributions (sampling.rs).

Warps are pure batched math.  Distribution1D/2D CDFs are built with cumsum
(host or device) and sampled with searchsorted — the batched form of the
reference's binary search (sampling.rs:46-177).
"""

import jax.numpy as jnp
import numpy as np

from ..config import PI, INV_PI, INV_2_PI, INV_4_PI, PI_OVER_2, PI_OVER_4


def uniform_sample_sphere(u):
    """(sampling.rs:233-244); u: (...,2) -> (...,3)"""
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_hemisphere(u):
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_hemisphere_pdf():
    return INV_2_PI


def uniform_sphere_pdf():
    return INV_4_PI


def concentric_sample_disk(u):
    """(sampling.rs:286-311)"""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    use_x = jnp.abs(x) > jnp.abs(y)
    # guard divisions; masked out below
    safe_x = jnp.where(x == 0.0, 1.0, x)
    safe_y = jnp.where(y == 0.0, 1.0, y)
    r = jnp.where(use_x, x, y)
    theta = jnp.where(
        use_x, PI_OVER_4 * (y / safe_x), PI_OVER_2 - PI_OVER_4 * (x / safe_y)
    )
    d = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1) * r[..., None]
    return jnp.where(zero[..., None], 0.0, d)


def cosine_sample_hemisphere(u):
    """Malley's method (sampling.rs:273-278)."""
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = u[..., 1] * 2.0 * PI
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """(sampling.rs:324-328)"""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, (f * f) / jnp.maximum(denom, 1e-30), 0.0)


class Distribution1D:
    """Piecewise-constant 1D distribution.

    Built on host (numpy f64) at scene-load time, sampled on device.
    Matches Distribution1D (sampling.rs:10-127): cdf[0]=0, cdf[i] cumulative,
    uniform fallback when the integral is zero.
    """

    def __init__(self, func):
        func = np.asarray(func, dtype=np.float64)
        n = len(func)
        cdf = np.zeros(n + 1)
        cdf[1:] = np.cumsum(func) / n
        func_int = cdf[n]
        if func_int == 0.0:
            cdf[1:] = np.arange(1, n + 1) / n
        else:
            cdf[1:] /= func_int
        self.func = func
        self.cdf = cdf
        self.func_int = func_int
        self.n = n

    def as_device(self, dtype=jnp.float32):
        return {
            "func": jnp.asarray(self.func, dtype=dtype),
            "cdf": jnp.asarray(self.cdf, dtype=dtype),
            "func_int": jnp.asarray(self.func_int, dtype=dtype),
        }


def sample_discrete_1d(dist, u):
    """Device-side Distribution1D::sample_discrete (sampling.rs:91-126).

    dist: dict from Distribution1D.as_device(); u: (...,) uniforms.
    Returns (index, pdf).
    """
    cdf, func, func_int = dist["cdf"], dist["func"], dist["func_int"]
    n = func.shape[0]
    # find_interval: last index with cdf[i] <= u
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1, 0, n - 1)
    pdf = jnp.where(func_int > 0.0, func[idx] / (func_int * n), 0.0)
    return idx, pdf


def sample_continuous_1d(dist, u):
    """Device-side Distribution1D::sample_continuous (sampling.rs:46-90).

    Returns (x in [0,1), pdf, offset).
    """
    cdf, func, func_int = dist["cdf"], dist["func"], dist["func_int"]
    n = func.shape[0]
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1, 0, n - 1)
    c0 = cdf[idx]
    dc = cdf[idx + 1] - c0
    du = jnp.where(dc > 0.0, (u - c0) / jnp.maximum(dc, 1e-30), u - c0)
    pdf = jnp.where(func_int > 0.0, func[idx] / jnp.maximum(func_int, 1e-30), 0.0)
    return (idx + du) / n, pdf, idx


class Distribution2D:
    """2D distribution: conditional rows + marginal (sampling.rs:130-177).

    Stored as dense device arrays: cond_func (nv,nu), cond_cdf (nv,nu+1),
    cond_int (nv,), marginal 1D.
    """

    def __init__(self, func, nu, nv):
        func = np.asarray(func, dtype=np.float64).reshape(nv, nu)
        cdf = np.zeros((nv, nu + 1))
        cdf[:, 1:] = np.cumsum(func, axis=1) / nu
        func_int = cdf[:, nu].copy()
        zero = func_int == 0.0
        cdf[zero, 1:] = np.arange(1, nu + 1) / nu
        nz = ~zero
        cdf[nz, 1:] /= func_int[nz, None]
        self.cond_func = func
        self.cond_cdf = cdf
        self.cond_int = func_int
        self.marginal = Distribution1D(func_int)
        self.nu, self.nv = nu, nv

    def as_device(self, dtype=jnp.float32):
        return {
            "cond_func": jnp.asarray(self.cond_func, dtype=dtype),
            "cond_cdf": jnp.asarray(self.cond_cdf, dtype=dtype),
            "cond_int": jnp.asarray(self.cond_int, dtype=dtype),
            "marginal": self.marginal.as_device(dtype),
        }


def sample_continuous_2d(dist2, u):
    """Device Distribution2D::sample_continuous (sampling.rs:157-167).

    u: (...,2) -> (p in [0,1)^2, pdf).
    """
    d1, pdf1, v = sample_continuous_1d(dist2["marginal"], u[..., 1])
    cond_cdf = dist2["cond_cdf"][v]  # (..., nu+1)
    cond_func = dist2["cond_func"][v]
    cond_int = dist2["cond_int"][v]
    nu = dist2["cond_func"].shape[1]
    uu = u[..., 0]
    idx = jnp.clip(
        _searchsorted_rows(cond_cdf, uu) - 1, 0, nu - 1
    )
    c0 = jnp.take_along_axis(cond_cdf, idx[..., None], axis=-1)[..., 0]
    c1 = jnp.take_along_axis(cond_cdf, (idx + 1)[..., None], axis=-1)[..., 0]
    dc = c1 - c0
    du = jnp.where(dc > 0.0, (uu - c0) / jnp.maximum(dc, 1e-30), uu - c0)
    f = jnp.take_along_axis(cond_func, idx[..., None], axis=-1)[..., 0]
    pdf0 = jnp.where(cond_int > 0.0, f / jnp.maximum(cond_int, 1e-30), 0.0)
    d0 = (idx + du) / nu
    return jnp.stack([d0, d1], axis=-1), pdf0 * pdf1


def pdf_2d(dist2, p):
    """Distribution2D::pdf (sampling.rs:168-177)."""
    nu = dist2["cond_func"].shape[1]
    nv = dist2["cond_func"].shape[0]
    iu = jnp.clip((p[..., 0] * nu).astype(jnp.int32), 0, nu - 1)
    iv = jnp.clip((p[..., 1] * nv).astype(jnp.int32), 0, nv - 1)
    m_int = dist2["marginal"]["func_int"]
    return dist2["cond_func"][iv, iu] / jnp.maximum(m_int, 1e-30)


def _searchsorted_rows(cdf_rows, u):
    """Vectorized searchsorted along the last axis: number of entries <= u."""
    return jnp.sum(cdf_rows <= u[..., None], axis=-1).astype(jnp.int32)
