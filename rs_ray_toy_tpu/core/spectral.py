"""Sampled-spectral (N=60) rendering machinery (spectrum.rs:2398-2749).

The reference selects the spectrum representation at compile time
(main.rs:45-49, SPECTRUM_N = 3 | 60); here it is a config axis: scenes
loaded with spectral=True carry (..., 60) radiometric channels through
the integrators, converted to XYZ at film-splat time (film stays 3-wide,
exactly like the reference's Film which stores XYZ for either mode).

Host table construction mirrors SampledSpectrumStatic
(spectrum.rs:2544-2594): the CIE curves and Smits RGB->spectrum bases
(core/cie_data.py) are resampled to N uniform bins over [400, 700] nm
with the piecewise-linear segment average of average_spectrum_samples
(spectrum.rs:2652-2711).

Device-facing ops (jnp, batched over leading dims):
  from_rgb(rgb, kind)  (...,3)  -> (...,N)   Smits reconstruction
  to_xyz(s) / to_rgb(s) (...,N) -> (...,3)
  y(s)                  (...,N) -> (...)     luminance
"""

import functools

import numpy as np
import jax.numpy as jnp

from . import cie_data as cd

N_SPECTRAL_SAMPLES = 60
SAMPLED_LAMBDA_START = 400.0
SAMPLED_LAMBDA_END = 700.0

REFLECTANCE = 0
ILLUMINANT = 1


def average_spectrum_samples(lam, vals, wl0, wl1):
    """(spectrum.rs:2652-2711) piecewise-linear average of (lam, vals)
    over [wl0, wl1]; constant extension outside the sample range."""
    lam = np.asarray(lam, np.float64)
    vals = np.asarray(vals, np.float64)
    n = len(lam)
    if wl1 <= lam[0]:
        return float(vals[0])
    if wl0 >= lam[-1]:
        return float(vals[-1])
    if n == 1:
        return float(vals[0])
    total = 0.0
    if wl0 < lam[0]:
        total += vals[0] * (lam[0] - wl0)
    if wl1 > lam[-1]:
        total += vals[-1] * (wl1 - lam[-1])
    i = 0
    while wl0 > lam[i + 1]:
        i += 1

    def interp(w, i):
        t = (w - lam[i]) / (lam[i + 1] - lam[i])
        return vals[i] * (1.0 - t) + vals[i + 1] * t

    while i + 1 < n and wl1 >= lam[i]:
        seg_start = max(wl0, lam[i])
        seg_end = min(wl1, lam[i + 1])
        if seg_end > seg_start:
            total += (
                0.5 * (interp(seg_start, i) + interp(seg_end, i))
                * (seg_end - seg_start)
            )
        i += 1
    return float(total / (wl1 - wl0))


def resample_to_bins(lam, vals, n=N_SPECTRAL_SAMPLES):
    """SampledSpectrum::from_sampled (spectrum.rs:2420-2440): bin
    averages over the N uniform [400, 700] segments."""
    order = np.argsort(np.asarray(lam, np.float64))
    lam = np.asarray(lam, np.float64)[order]
    vals = np.asarray(vals, np.float64)[order]
    out = np.zeros(n)
    for i in range(n):
        wl0 = SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * i / n
        wl1 = SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * (i + 1) / n
        out[i] = average_spectrum_samples(lam, vals, wl0, wl1)
    return out


@functools.lru_cache()
def tables(n=N_SPECTRAL_SAMPLES):
    """SampledSpectrumStatic (spectrum.rs:2544-2594): all 60-bin tables."""
    t = {}
    for name, vals in (
        ("x", cd.CIE_X), ("y", cd.CIE_Y), ("z", cd.CIE_Z),
    ):
        t[name] = resample_to_bins(cd.CIE_LAMBDA, vals, n)
    basis_names = (
        "white", "cyan", "magenta", "yellow", "red", "green", "blue",
    )
    for kind in ("refl", "illum"):
        for b in basis_names:
            src = getattr(cd, f"RGB_{kind.upper()}_2_SPECT_{b.upper()}")
            t[f"{kind}_{b}"] = resample_to_bins(cd.RGB_2_SPECTLAMBDA, src, n)
    return {k: np.asarray(v) for k, v in t.items()}


def _basis(kind):
    t = tables()
    p = "refl" if kind == REFLECTANCE else "illum"
    return {b: jnp.asarray(t[f"{p}_{b}"], jnp.float32)
            for b in ("white", "cyan", "magenta", "yellow", "red", "green", "blue")}


def from_rgb(rgb, kind=REFLECTANCE):
    """Smits reconstruction, batched (spectrum.rs:2616-2695).

    rgb: (..., 3) -> (..., N).  Branch structure identical to the
    reference (minimum channel selects the base, then two secondary
    bases), vectorized with nested where."""
    bs = _basis(kind)
    w, c, m, yb = bs["white"], bs["cyan"], bs["magenta"], bs["yellow"]
    rd, g, b = bs["red"], bs["green"], bs["blue"]
    r0 = rgb[..., 0:1]
    r1 = rgb[..., 1:2]
    r2 = rgb[..., 2:3]

    # case A: rgb[0] minimal
    a_in = jnp.where(
        r1 <= r2,
        w * r0 + c * (r1 - r0) + b * (r2 - r1),
        w * r0 + c * (r2 - r0) + g * (r1 - r2),
    )
    # case B: rgb[1] minimal
    b_in = jnp.where(
        r0 <= r2,
        w * r1 + m * (r0 - r1) + b * (r2 - r0),
        w * r1 + m * (r2 - r1) + rd * (r0 - r2),
    )
    # case C: rgb[2] minimal
    c_in = jnp.where(
        r0 <= r1,
        w * r2 + yb * (r0 - r2) + g * (r1 - r0),
        w * r2 + yb * (r1 - r2) + rd * (r0 - r1),
    )
    out = jnp.where(
        (r0 <= r1) & (r0 <= r2),
        a_in,
        jnp.where((r1 <= r0) & (r1 <= r2), b_in, c_in),
    )
    out = out * (0.94 if kind == REFLECTANCE else 0.86445)
    return jnp.clip(out, 0.0, jnp.inf)


def _xyz_mat():
    t = tables()
    scale = (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) / (
        cd.CIE_Y_INTEGRAL * N_SPECTRAL_SAMPLES
    )
    return jnp.asarray(
        np.stack([t["x"], t["y"], t["z"]], 0) * scale, jnp.float32
    )  # (3, N)


def to_xyz(s):
    """(spectrum.rs:2585-2601): (..., N) -> (..., 3)."""
    return jnp.einsum("cn,...n->...c", _xyz_mat(), s, precision="highest")


def y(s):
    """Luminance (spectrum.rs:2602-2609)."""
    return jnp.einsum("n,...n->...", _xyz_mat()[1], s, precision="highest")


def to_rgb(s):
    from .spectrum import xyz_to_rgb

    return xyz_to_rgb(to_xyz(s))


def blackbody(lam_nm, t_kelvin):
    """Planck emitted radiance (spectrum.rs:2108-2125); lam in nm."""
    lam_nm = np.asarray(lam_nm, np.float64)
    if t_kelvin <= 0:
        return np.zeros_like(lam_nm)
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l = lam_nm * 1e-9
    return (2.0 * h * c * c) / (l**5 * (np.exp((h * c) / (l * kb * t_kelvin)) - 1.0))


def blackbody_normalized(lam_nm, t_kelvin):
    """(spectrum.rs:2127-2135): normalized by the Wien-peak radiance."""
    le = blackbody(lam_nm, t_kelvin)
    lambda_max = 2.8977721e-3 / t_kelvin * 1e9
    return le / blackbody(np.asarray([lambda_max]), t_kelvin)[0]


def sampled_bin_wavelengths(n=N_SPECTRAL_SAMPLES):
    """Bin-center wavelengths of the N uniform segments."""
    i = np.arange(n) + 0.5
    return SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * i / n
