"""Spectrum as a trailing channel dimension.

The reference's Spectrum<const N> (spectrum.rs:2146) becomes a `(..., 3)`
array (RGB default; SPECTRUM_N is a config axis).  Conversions replicate
spectrum.rs:2075-2091 exactly, and luminance y() replicates the RGB impl's
weights (spectrum.rs:2700-2748).
"""

import numpy as np
import jax.numpy as jnp


def xyz_to_rgb(xyz):
    """(spectrum.rs:2075-2082)"""
    m = jnp.asarray(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ],
        dtype=xyz.dtype,
    )
    return jnp.einsum("ij,...j->...i", m, xyz, precision="highest")


def rgb_to_xyz(rgb):
    """(spectrum.rs:2084-2091)"""
    m = jnp.asarray(
        [
            [0.412453, 0.357580, 0.180423],
            [0.212671, 0.715160, 0.072169],
            [0.019334, 0.119193, 0.950227],
        ],
        dtype=rgb.dtype,
    )
    return jnp.einsum("ij,...j->...i", m, rgb, precision="highest")


def luminance(rgb):
    """y() of RGBSpectrum = the XYZ Y row (spectrum.rs:2602-2609)."""
    w = jnp.asarray([0.212671, 0.715160, 0.072169], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def lum_any(v):
    """Channel-agnostic luminance: RGB y() for 3-wide, sampled-spectrum
    y() (spectrum.rs:2602-2609) for N-wide arrays."""
    if v.shape[-1] == 3:
        return luminance(v)
    from . import spectral

    return spectral.y(v)


def gamma_correct(v):
    """sRGB encode (misc.rs:46-52); jnp, batched."""
    return jnp.where(
        v <= 0.0031308, 12.92 * v, 1.055 * jnp.maximum(v, 1e-30) ** (1.0 / 2.4) - 0.055
    )


def inverse_gamma_correct(v):
    """sRGB decode (misc.rs gamma 2.4 inverse); used for 8-bit texture load."""
    return jnp.where(
        v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4
    )


# CIE matching-function integrals are only needed for SPECTRUM_N=60 sampled
# mode (spectrum.rs:2398-2549); the sampled-spectral path reduces copper-style
# eta/k tables to RGB at load time via from_sampled() below.

def from_sampled_rgb(lambdas, vals):
    """Reduce sampled spectrum to RGB the way the reference does for the
    RGB compile-time configuration.

    With SPECTRUM_N=3 the reference's Spectrum::from_sampled sorts samples,
    integrates against the CIE curves to XYZ and converts to RGB
    (spectrum.rs RGB impl).  We reproduce that with the standard CIE 1931
    tables at 1nm resolution approximated by 5nm interpolation (numpy host
    code, load-time only).
    """
    lambdas = np.asarray(lambdas, dtype=np.float64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.argsort(lambdas)
    lambdas, vals = lambdas[order], vals[order]

    cie = _cie_tables()
    lam = cie["lambda"]
    interp = np.interp(lam, lambdas, vals, left=vals[0], right=vals[-1])
    y_int = np.sum(cie["y"])
    xyz = np.array(
        [
            np.sum(interp * cie["x"]) / y_int,
            np.sum(interp * cie["y"]) / y_int,
            np.sum(interp * cie["z"]) / y_int,
        ]
    )
    m = np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ]
    )
    return m @ xyz


_CIE = None


def _cie_tables():
    """Compact CIE 1931 standard observer at 5nm from 380 to 780 (the
    classic 81-sample table); adequate for reducing smooth conductor eta/k
    curves to RGB."""
    global _CIE
    if _CIE is not None:
        return _CIE
    lam = np.arange(380.0, 781.0, 5.0)
    # 81-entry CIE 1931 2-deg color matching functions (x̄, ȳ, z̄).
    x = np.array([
        0.001368, 0.002236, 0.004243, 0.007650, 0.014310, 0.023190, 0.043510,
        0.077630, 0.134380, 0.214770, 0.283900, 0.328500, 0.348280, 0.348060,
        0.336200, 0.318700, 0.290800, 0.251100, 0.195360, 0.142100, 0.095640,
        0.057950, 0.032010, 0.014700, 0.004900, 0.002400, 0.009300, 0.029100,
        0.063270, 0.109600, 0.165500, 0.225750, 0.290400, 0.359700, 0.433450,
        0.512050, 0.594500, 0.678400, 0.762100, 0.842500, 0.916300, 0.978600,
        1.026300, 1.056700, 1.062200, 1.045600, 1.002600, 0.938400, 0.854450,
        0.751400, 0.642400, 0.541900, 0.447900, 0.360800, 0.283500, 0.218700,
        0.164900, 0.121200, 0.087400, 0.063600, 0.046770, 0.032900, 0.022700,
        0.015840, 0.011359, 0.008111, 0.005790, 0.004109, 0.002899, 0.002049,
        0.001440, 0.001000, 0.000690, 0.000476, 0.000332, 0.000235, 0.000166,
        0.000117, 0.000083, 0.000059, 0.000042])
    y = np.array([
        0.000039, 0.000064, 0.000120, 0.000217, 0.000396, 0.000640, 0.001210,
        0.002180, 0.004000, 0.007300, 0.011600, 0.016840, 0.023000, 0.029800,
        0.038000, 0.048000, 0.060000, 0.073900, 0.090980, 0.112600, 0.139020,
        0.169300, 0.208020, 0.258600, 0.323000, 0.407300, 0.503000, 0.608200,
        0.710000, 0.793200, 0.862000, 0.914850, 0.954000, 0.980300, 0.994950,
        1.000000, 0.995000, 0.978600, 0.952000, 0.915400, 0.870000, 0.816300,
        0.757000, 0.694900, 0.631000, 0.566800, 0.503000, 0.441200, 0.381000,
        0.321000, 0.265000, 0.217000, 0.175000, 0.138200, 0.107000, 0.081600,
        0.061000, 0.044580, 0.032000, 0.023200, 0.017000, 0.011920, 0.008210,
        0.005723, 0.004102, 0.002929, 0.002091, 0.001484, 0.001047, 0.000740,
        0.000520, 0.000361, 0.000249, 0.000172, 0.000120, 0.000085, 0.000060,
        0.000042, 0.000030, 0.000021, 0.000015])
    z = np.array([
        0.006450, 0.010550, 0.020050, 0.036210, 0.067850, 0.110200, 0.207400,
        0.371300, 0.645600, 1.039050, 1.385600, 1.622960, 1.747060, 1.782600,
        1.772110, 1.744100, 1.669200, 1.528100, 1.287640, 1.041900, 0.812950,
        0.616200, 0.465180, 0.353300, 0.272000, 0.212300, 0.158200, 0.111700,
        0.078250, 0.057250, 0.042160, 0.029840, 0.020300, 0.013400, 0.008750,
        0.005750, 0.003900, 0.002750, 0.002100, 0.001800, 0.001650, 0.001400,
        0.001100, 0.001000, 0.000800, 0.000600, 0.000340, 0.000240, 0.000190,
        0.000100, 0.000050, 0.000030, 0.000020, 0.000010, 0.000000, 0.000000,
        0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
        0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
        0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
        0.000000, 0.000000, 0.000000, 0.000000])
    _CIE = {"lambda": lam, "x": x, "y": y, "z": z}
    return _CIE
