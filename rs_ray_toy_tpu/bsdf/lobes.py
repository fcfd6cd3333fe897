"""Material -> lobe-table compilation.

The reference assembles a per-hit Vec<Arc<dyn BxDF>> inside each material's
compute_scattering_functions (matte.rs:35-61, plastic.rs, metal.rs, glass.rs,
translucent.rs, mirror.rs, mixmat.rs, debug_material.rs).  On the device
that dynamic lobe list becomes a *static* per-material recipe compiled at scene
load into fixed-width SoA rows:

    materials[m] -> up to MAX_LOBES lobes, each with a type code, BxDF flag
    bits, two spectra, and four scalar params.

Shading then evaluates lobes data-parallel with masked type dispatch
(bsdf/eval.py), gathering rows by per-hit material id.  Texture-driven
params carry a texture id (-1 = the constant stored inline), resolved by
scene/textures.py at hit time.
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE

MAX_LOBES = 8  # reference MAX_BXDFS (reflection.rs:202)

# BxDF flag bits (reflection.rs:415-423)
BXDF_REFLECTION = 1 << 0
BXDF_TRANSMISSION = 1 << 1
BXDF_DIFFUSE = 1 << 2
BXDF_GLOSSY = 1 << 3
BXDF_SPECULAR = 1 << 4
BXDF_ALL = (
    BXDF_REFLECTION | BXDF_TRANSMISSION | BXDF_DIFFUSE | BXDF_GLOSSY | BXDF_SPECULAR
)
BXDF_NONE = 0

# lobe type codes
LOBE_NONE = 0
LOBE_LAMBERT_REFL = 1
LOBE_OREN_NAYAR = 2
LOBE_LAMBERT_TRANS = 3
LOBE_SPEC_REFL = 4
LOBE_SPEC_TRANS = 5
LOBE_FRESNEL_SPEC = 6
LOBE_MF_REFL = 7
LOBE_MF_TRANS = 8
LOBE_FRESNEL_BLEND = 9
LOBE_DEBUG_DIFFUSE = 10
LOBE_DEBUG_SPECULAR = 11
# Disney lobes (material/disney.rs) — wired in a later phase
LOBE_DISNEY_DIFFUSE = 12
LOBE_DISNEY_FAKE_SS = 13
LOBE_DISNEY_RETRO = 14
LOBE_DISNEY_SHEEN = 15
LOBE_DISNEY_CLEARCOAT = 16
LOBE_DISNEY_MICROFACET_REFL = 17

LOBE_FLAGS = {
    LOBE_NONE: BXDF_NONE,
    LOBE_LAMBERT_REFL: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_OREN_NAYAR: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_LAMBERT_TRANS: BXDF_DIFFUSE | BXDF_TRANSMISSION,
    LOBE_SPEC_REFL: BXDF_SPECULAR | BXDF_REFLECTION,
    LOBE_SPEC_TRANS: BXDF_SPECULAR | BXDF_TRANSMISSION,
    LOBE_FRESNEL_SPEC: BXDF_SPECULAR | BXDF_ALL,  # reflection.rs:801-803
    LOBE_MF_REFL: BXDF_GLOSSY | BXDF_REFLECTION,
    LOBE_MF_TRANS: BXDF_GLOSSY | BXDF_TRANSMISSION,
    LOBE_FRESNEL_BLEND: BXDF_GLOSSY | BXDF_REFLECTION,
    LOBE_DEBUG_DIFFUSE: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DEBUG_SPECULAR: BXDF_SPECULAR | BXDF_REFLECTION,
    LOBE_DISNEY_DIFFUSE: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_FAKE_SS: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_RETRO: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_SHEEN: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_CLEARCOAT: BXDF_GLOSSY | BXDF_REFLECTION,
    LOBE_DISNEY_MICROFACET_REFL: BXDF_GLOSSY | BXDF_REFLECTION,
}

# fresnel codes (reflection.rs:565-619)
FRESNEL_NOOP = 0
FRESNEL_DIELECTRIC = 1
FRESNEL_CONDUCTOR = 2
FRESNEL_DISNEY = 3

# Disney textured-parameter lobe roles (disney.rs:530-676 evaluates every
# parameter texture per hit and assembles lobes dynamically; the packed
# table stores a canonical slot layout whose numeric params + per-hit
# gates are recomputed on device by eval._assemble_disney_textured).
DR_NONE = 0
DR_DIFFUSE = 1
DR_DIFFUSE_THIN = 2
DR_FAKE_SS = 3
DR_RETRO = 4
DR_SHEEN = 5
DR_MF_REFL = 6
DR_CLEARCOAT = 7
DR_MF_TRANS = 8
DR_MF_TRANS_THIN = 9
DR_LAMBERT_TRANS = 10

# base-parameter column order for disney_base_const / disney_base_tex
DISNEY_BASE_PARAMS = (
    "color", "metallic", "eta", "roughness", "specular_tint", "anisotropic",
    "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss", "spec_trans",
    "flatness", "diff_trans",
)

# microfacet distribution codes (microfacet.rs)
DIST_TROWBRIDGE_REITZ = 0
DIST_BECKMANN = 1
DIST_DISNEY_GTR1 = 2
# TR D/lambda but Disney's separable masking-shadowing G = G1(wo)G1(wi)
# (DisneyMicrofacetDistribution, disney.rs:345-360)
DIST_DISNEY_SEPARABLE_G = 3


@dataclass
class Lobe:
    """One host-side lobe row before packing."""

    kind: int
    s0: np.ndarray = field(default_factory=lambda: np.zeros(3))  # R/T/Rd
    s1: np.ndarray = field(default_factory=lambda: np.zeros(3))  # T/Rs/k
    s2: np.ndarray = field(default_factory=lambda: np.zeros(3))  # conductor eta
    # scalars: meaning per lobe kind
    #  spec/fresnel: f0=eta_a, f1=eta_b
    #  microfacet:   f0=rough_u, f1=rough_v (pre-remap), f2=eta_a, f3=eta_b
    #  oren-nayar:   f0=sigma (degrees)
    f0: float = 0.0
    f1: float = 0.0
    f2: float = 0.0
    f3: float = 0.0
    fresnel: int = FRESNEL_NOOP
    dist: int = DIST_TROWBRIDGE_REITZ
    remap_roughness: bool = False
    sample_visible: bool = True
    # texture indirection (-1 == use inline constant)
    s0_tex: int = -1
    rough_u_tex: int = -1
    rough_v_tex: int = -1
    sigma_tex: int = -1
    # mix-material scale (ScaledBxdf, reflection.rs:516-563)
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))
    scale_tex: int = -1
    scale_one_minus: bool = False  # second half of MixMaterial uses 1-s


@dataclass
class HostMaterial:
    name: str
    eta: float  # Bsdf::eta (reflection.rs:205-216); 1.0 for opaque
    lobes: List[Lobe]
    bump_tex: int = -1
    # Disney BSSRDF profile (disney.rs:585-601); None when absent
    bssrdf_R: object = None
    bssrdf_d: object = None
    bssrdf_eta: float = 1.0
    # textured Disney: per-slot role codes + base-param (const, tex) table;
    # None for every other material
    disney_roles: object = None  # list[int], len == len(lobes)
    disney_base_const: object = None  # (13, 3) float
    disney_base_tex: object = None  # (13,) int texture ids


class MaterialTableBuilder:
    def __init__(self):
        self.materials: List[HostMaterial] = []

    def add(self, mat: HostMaterial) -> int:
        assert len(mat.lobes) <= MAX_LOBES
        self.materials.append(mat)
        return len(self.materials) - 1

    def pack(self, n_channels=3):
        """Pack to device arrays: dict of (M, L, ...) tables with L trimmed
        to the scene's actual max lobe count (smaller unrolled loops).

        n_channels=60 selects the sampled-spectral axis: 3-wide lobe
        spectra are lifted via the Smits reflectance basis
        (core/spectral.py), except conductor n/k which use the sampled
        copper data when they carry the copper defaults."""
        C = n_channels

        def lift(v, lobe=None, which=None):
            v = np.asarray(v, np.float64) * np.ones(3) if np.ndim(v) == 0 else np.asarray(v, np.float64)
            if C == 3 or v.shape[-1] == C:
                return v
            if v.min() == v.max():
                # neutral constants (Spectrum::from(s)) are FLAT spectra in
                # the reference, not Smits-lifted gray (which carries ~0.4%
                # ripple): scale=1, metal R=1, glass kr/kt=1, zeros
                return np.full(C, float(v[0]))
            import jax.numpy as _jnp

            from ..core import spectral as _sp

            if lobe is not None and lobe.fresnel == FRESNEL_CONDUCTOR and which in ("s1", "s2"):
                from ..scene.loader import (
                    COPPER_K_RGB,
                    COPPER_N_RGB,
                    _COPPER_K,
                    _COPPER_N,
                    _COPPER_WAVELENGTHS,
                )

                if which == "s2" and np.allclose(v, COPPER_N_RGB):
                    return _sp.resample_to_bins(_COPPER_WAVELENGTHS, _COPPER_N, C)
                if which == "s1" and np.allclose(v, COPPER_K_RGB):
                    return _sp.resample_to_bins(_COPPER_WAVELENGTHS, _COPPER_K, C)
            return np.asarray(
                _sp.from_rgb(_jnp.asarray(v, _jnp.float32), _sp.REFLECTANCE),
                np.float64,
            )

        m = max(1, len(self.materials))
        MAX_LOBES = max(
            [1] + [len(mat.lobes) for mat in self.materials]
        )
        kind = np.zeros((m, MAX_LOBES), np.int32)
        flags = np.zeros((m, MAX_LOBES), np.int32)
        s0 = np.zeros((m, MAX_LOBES, C), np.float32)
        s1 = np.zeros((m, MAX_LOBES, C), np.float32)
        s2 = np.zeros((m, MAX_LOBES, C), np.float32)
        fparams = np.zeros((m, MAX_LOBES, 4), np.float32)
        fresnel = np.zeros((m, MAX_LOBES), np.int32)
        dist = np.zeros((m, MAX_LOBES), np.int32)
        remap = np.zeros((m, MAX_LOBES), bool)
        sample_vis = np.zeros((m, MAX_LOBES), bool)
        s0_tex = np.full((m, MAX_LOBES), -1, np.int32)
        rough_u_tex = np.full((m, MAX_LOBES), -1, np.int32)
        rough_v_tex = np.full((m, MAX_LOBES), -1, np.int32)
        sigma_tex = np.full((m, MAX_LOBES), -1, np.int32)
        scale = np.ones((m, MAX_LOBES, C), np.float32)
        scale_tex = np.full((m, MAX_LOBES), -1, np.int32)
        scale_one_minus = np.zeros((m, MAX_LOBES), bool)
        n_lobes = np.zeros((m,), np.int32)
        eta = np.ones((m,), np.float32)
        bump_tex = np.full((m,), -1, np.int32)
        has_bssrdf = np.zeros((m,), bool)
        bssrdf_R = np.zeros((m, C), np.float32)
        bssrdf_d = np.full((m, C), 1.0, np.float32)
        bssrdf_eta = np.ones((m,), np.float32)
        disney_roles = np.zeros((m, MAX_LOBES), np.int32)
        disney_base_const = np.zeros((m, 13, 3), np.float32)
        disney_base_tex = np.full((m, 13), -1, np.int32)
        is_disney_tex = np.zeros((m,), bool)

        for i, mat in enumerate(self.materials):
            n_lobes[i] = len(mat.lobes)
            eta[i] = mat.eta
            bump_tex[i] = mat.bump_tex
            if mat.bssrdf_R is not None:
                has_bssrdf[i] = True
                # spectral: R is a reflectance (Smits lift); the per-channel
                # scatter distance d is an RGB-parameterized length — the
                # same linear from_rgb lift keeps sr_profile/sample_sr
                # consistent across the channel axis (disney.rs
                # scatter_distance under the N=60 build)
                bssrdf_R[i] = lift(mat.bssrdf_R)
                bssrdf_d[i] = np.maximum(lift(mat.bssrdf_d), 1e-6)
                bssrdf_eta[i] = mat.bssrdf_eta
            if mat.disney_roles is not None:
                is_disney_tex[i] = True
                disney_roles[i, : len(mat.disney_roles)] = mat.disney_roles
                disney_base_const[i] = mat.disney_base_const
                disney_base_tex[i] = mat.disney_base_tex
            for j, lb in enumerate(mat.lobes):
                kind[i, j] = lb.kind
                flags[i, j] = LOBE_FLAGS[lb.kind]
                s0[i, j] = lift(lb.s0, lb, "s0")
                s1[i, j] = lift(lb.s1, lb, "s1")
                s2[i, j] = lift(lb.s2, lb, "s2")
                fparams[i, j] = [lb.f0, lb.f1, lb.f2, lb.f3]
                fresnel[i, j] = lb.fresnel
                dist[i, j] = lb.dist
                remap[i, j] = lb.remap_roughness
                sample_vis[i, j] = lb.sample_visible
                s0_tex[i, j] = lb.s0_tex
                rough_u_tex[i, j] = lb.rough_u_tex
                rough_v_tex[i, j] = lb.rough_v_tex
                sigma_tex[i, j] = lb.sigma_tex
                scale[i, j] = lift(lb.scale, lb, "scale")
                scale_tex[i, j] = lb.scale_tex
                scale_one_minus[i, j] = lb.scale_one_minus

        # fused gather layout: one float tensor + one int tensor per lobe
        # slot (shade-time gathers cost per-array; 2 gathers beat ~20)
        packed_f = np.concatenate(
            [s0, s1, s2, fparams, scale], axis=-1
        ).astype(np.float32)  # (M, L, 4C+4); 16 for RGB
        packed_i = np.stack(
            [
                kind, flags, fresnel, dist,
                remap.astype(np.int32), sample_vis.astype(np.int32),
                s0_tex, rough_u_tex, rough_v_tex, sigma_tex, scale_tex,
                scale_one_minus.astype(np.int32),
            ],
            axis=-1,
        ).astype(np.int32)  # (M, L, 12)

        as_j = lambda a: jnp.asarray(a)
        return {
            "packed_f": as_j(packed_f),
            "packed_i": as_j(packed_i),
            "kind": as_j(kind),
            "flags": as_j(flags),
            "s0": as_j(s0),
            "s1": as_j(s1),
            "s2": as_j(s2),
            "fparams": as_j(fparams),
            "fresnel": as_j(fresnel),
            "dist": as_j(dist),
            "remap": as_j(remap),
            "sample_visible": as_j(sample_vis),
            "s0_tex": as_j(s0_tex),
            "rough_u_tex": as_j(rough_u_tex),
            "rough_v_tex": as_j(rough_v_tex),
            "sigma_tex": as_j(sigma_tex),
            "scale": as_j(scale),
            "scale_tex": as_j(scale_tex),
            "scale_one_minus": as_j(scale_one_minus),
            "n_lobes": as_j(n_lobes),
            "eta": as_j(eta),
            "bump_tex": as_j(bump_tex),
            "has_bssrdf": as_j(has_bssrdf),
            "bssrdf_R": as_j(bssrdf_R),
            "bssrdf_d": as_j(bssrdf_d),
            "bssrdf_eta": as_j(bssrdf_eta),
            "is_disney_tex": as_j(is_disney_tex),
            "disney_roles": as_j(disney_roles[:, :MAX_LOBES]),
            "disney_base_const": as_j(disney_base_const),
            "disney_base_tex": as_j(disney_base_tex),
            "n_channels": C,
        }
