"""Scene JSON loader — byte-compatible with the reference schema.

Parses the exact document structure renderprocess.rs consumes
(sections float_texture / rgb_texture / materials / objs / lights /
infinite_lights / Aggregate / Integrator / Sampler / Film / Camera;
dispatch at renderprocess.rs:254-280,1399-1499) with the same typed
accessors and defaults (read_i64/read_f64/read_bool/read_string,
renderprocess.rs:136-196) and the common to_world block
(world_pos/rotation_axis/rotation_angle/scale -> T*R*S,
renderprocess.rs:242-252).

Output is a host `RenderJob` whose scene side is flat device arrays:
triangle instances baked to world space, spheres with transform rows,
typed light table, packed material lobe table, texture registry.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE
from ..core.transform import Transform
from ..core import spectrum as spec
from ..bsdf import recipes
from ..bsdf.lobes import MaterialTableBuilder, HostMaterial
from ..bsdf.recipes import RGBParam, FloatParam
from . import textures as tex
from .objparser import parse_obj, ObjMesh
from ..utils.png import read_png
from .types import (
    AREA_SHAPE_NONE,
    AREA_SHAPE_SPHERE,
    AREA_SHAPE_TRIANGLE,
    LIGHT_DIFFUSE_AREA,
    LIGHT_DISTANT,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LightSoA,
    SphereSoA,
    TriangleSoA,
)

# ---- typed accessors (renderprocess.rs:136-240) ----


def read_i64(cfg, key, default):
    v = cfg.get(key)
    return int(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else default


def read_f64(cfg, key, default):
    v = cfg.get(key)
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else default


def read_bool(cfg, key, default):
    v = cfg.get(key)
    return v if isinstance(v, bool) else default


def read_string(cfg, key, default):
    v = cfg.get(key)
    return v if isinstance(v, str) else default


def fetch_xyz(cfg, key, default):
    v = cfg.get(key)
    if isinstance(v, list) and len(v) == 3 and all(
        isinstance(x, (int, float)) for x in v
    ):
        return np.array(v, dtype=np.float64)
    return np.asarray(default, dtype=np.float64)


def fetch_vector2(cfg, key, default):
    v = cfg.get(key)
    if isinstance(v, list) and len(v) == 2:
        return np.array(v, dtype=np.float64)
    return np.asarray(default, dtype=np.float64)


def make_to_world(cfg) -> Transform:
    """(renderprocess.rs:242-252)"""
    world_pos = fetch_xyz(cfg, "world_pos", [0.0, 0.0, 0.0])
    axis = fetch_xyz(cfg, "rotation_axis", [0.0, 0.0, 0.0])
    angle = read_f64(cfg, "rotation_angle", 0.0)
    scale = fetch_xyz(cfg, "scale", [1.0, 1.0, 1.0])
    return (
        Transform.translate(world_pos)
        * Transform.rotate(angle, axis)
        * Transform.scale(scale[0], scale[1], scale[2])
    )


def make_spectrum(cfg, key, default):
    """(renderprocess.rs:1055-1076): {"values": [r,g,b]} or scalar default."""
    v = cfg.get(key)
    if isinstance(v, dict) and isinstance(v.get("values"), list):
        return np.array(v["values"], dtype=np.float64)
    return np.full(3, float(default))


# ---- specs for the driver side ----


@dataclass
class FilmSpec:
    xres: int
    yres: int
    diagonal_mm: float
    scale: float
    max_sample_luminance: float
    filter_type: str
    filter_radius: np.ndarray
    gaussian_alpha: float = 2.0


@dataclass
class SamplerSpec:
    kind: str  # "stratified" | "halton"
    jitter: bool = True
    xsamp: int = 4
    ysamp: int = 4
    dimension: int = 4
    nsamp: int = 16
    sample_at_center: bool = False

    @property
    def spp(self):
        return self.xsamp * self.ysamp if self.kind == "stratified" else self.nsamp


@dataclass
class IntegratorSpec:
    kind: str
    max_depth: int = 5
    light_strategy: str = "one"
    rr_threshold: float = 1.0
    cos_sample: bool = True
    n_samples: int = 64
    # SPPM
    radius: float = 1.0
    n_iters: int = 5
    photons_per_iter: int = 1
    write_freq: int = 1 << 31


@dataclass
class CameraSpec:
    cam_to_world: Transform
    shutter_open: float
    shutter_close: float
    aperture_diameter: float
    focus_distance: float
    simple_weighting: bool
    lens_data: np.ndarray


@dataclass
class MediumSpec:
    kind: str  # "homogeneous" | "grid"
    sigma_a: np.ndarray
    sigma_s: np.ndarray
    g: float
    # grid
    nx: int = 1
    ny: int = 1
    nz: int = 1
    density: Optional[np.ndarray] = None
    world_to_medium: Optional[np.ndarray] = None


@dataclass
class SceneBundle:
    triangles: TriangleSoA
    spheres: SphereSoA
    lights: LightSoA
    materials: Dict
    registry: tex.TextureRegistry
    dev_images: List
    infinite: List[Dict]  # per-infinite-light device data
    world_bound: np.ndarray  # (2,3)
    max_prims_in_node: int
    mediums: List[MediumSpec] = field(default_factory=list)
    camera_medium: int = -1
    n_channels: int = 3  # 3 = RGB, 60 = sampled-spectral (main.rs:45-49)


@dataclass
class RenderJob:
    scene: SceneBundle
    camera: CameraSpec
    film: FilmSpec
    sampler: SamplerSpec
    integrator: IntegratorSpec


# copper spectral data (metal.rs COPPER_*): reduced to RGB at import via the
# CIE pipeline the reference uses for SPECTRUM_N=3.
_COPPER_WAVELENGTHS = np.array([
    298.7570554, 302.4004341, 306.1337728, 309.960445, 313.8839949,
    317.9081487, 322.036826, 326.2741526, 330.6244747, 335.092373,
    339.6826795, 344.4004944, 349.2512056, 354.2405086, 359.374429,
    364.6593471, 370.1020239, 375.7096303, 381.4897785, 387.4505563,
    393.6005651, 399.9489613, 406.5055016, 413.2805933, 420.2853492,
    427.5316483, 435.0322035, 442.8006357, 450.8515564, 459.2006593,
    467.8648226, 476.8622231, 486.2124627, 495.936712, 506.0578694,
    516.6007417, 527.5922468, 539.0616435, 551.0407911, 563.5644455,
    576.6705953, 590.4008476, 604.8008683, 619.92089, 635.8162974,
    652.5483053, 670.1847459, 688.8009889, 708.4810171, 729.3186941,
    751.4192606, 774.9011125, 799.8979226, 826.5611867, 855.0632966,
    885.6012714])
_COPPER_N = np.array([
    1.400313, 1.38, 1.358438, 1.34, 1.329063, 1.325, 1.3325, 1.34, 1.334375,
    1.325, 1.317812, 1.31, 1.300313, 1.29, 1.281563, 1.27, 1.249062, 1.225,
    1.2, 1.18, 1.174375, 1.175, 1.1775, 1.18, 1.178125, 1.175, 1.172812,
    1.17, 1.165312, 1.16, 1.155312, 1.15, 1.142812, 1.135, 1.131562, 1.12,
    1.092437, 1.04, 0.950375, 0.826, 0.645875, 0.468, 0.35125, 0.272,
    0.230813, 0.214, 0.20925, 0.213, 0.21625, 0.223, 0.2365, 0.25, 0.254188,
    0.26, 0.28, 0.3])
_COPPER_K = np.array([
    1.662125, 1.687, 1.703313, 1.72, 1.744563, 1.77, 1.791625, 1.81,
    1.822125, 1.834, 1.85175, 1.872, 1.89425, 1.916, 1.931688, 1.95,
    1.972438, 2.015, 2.121562, 2.21, 2.177188, 2.13, 2.160063, 2.21,
    2.249938, 2.289, 2.326, 2.362, 2.397625, 2.433, 2.469187, 2.504,
    2.535875, 2.564, 2.589625, 2.605, 2.595562, 2.583, 2.5765, 2.599,
    2.678062, 2.809, 3.01075, 3.24, 3.458187, 3.67, 3.863125, 4.05,
    4.239563, 4.43, 4.619563, 4.817, 5.034125, 5.26, 5.485625, 5.717])

COPPER_N_RGB = spec.from_sampled_rgb(_COPPER_WAVELENGTHS, _COPPER_N)
COPPER_K_RGB = spec.from_sampled_rgb(_COPPER_WAVELENGTHS, _COPPER_K)

# measured subsurface scattering presets (medium/mod.rs:101-344).  The full
# 47-entry table lands with the media phase; the default is the reference's
# fallback (renderprocess.rs:1126-1131).
_DEFAULT_SIGMA_A = np.array([0.0011, 0.0024, 0.014])
_DEFAULT_SIGMA_S = np.array([2.55, 3.21, 3.77])


def load_scene(path: str, spectral: bool = False) -> RenderJob:
    """Parse a scene JSON (byte-compatible with renderprocess.rs).

    spectral=True selects the sampled-spectral (N=60) channel axis the
    reference picks at compile time (main.rs:45-49, SPECTRUM_N=60):
    material reflectances and light spectra are lifted to 60 bins via the
    Smits bases / sampled data (core/spectral.py), and integrators carry
    (..., 60) radiometric arrays, converted to RGB at the film.
    Spectral coverage is COMPLETE as of round 3: media sigma spectra,
    env maps, textured params (per-hit device from_rgb), bump, debug
    materials, the Disney BSSRDF (R/scatter_distance lifted), and every
    integrator including SPPM (its ld/tau/phi state carries C channels;
    the driver converts at the film).
    """
    root_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        cfg = json.load(fh)

    registry = tex.TextureRegistry()
    float_tex: Dict[str, int] = {}
    rgb_tex: Dict[str, int] = {}
    _make_textures(cfg, root_dir, registry, float_tex, rgb_tex)

    integrator = _make_integrator_spec(cfg.get("Integrator", {}))
    allow_multiple_lobes = integrator.kind in ("path", "volpath")

    mat_builder = MaterialTableBuilder()
    mat_ids: Dict[str, int] = {}
    host_mats: Dict[str, HostMaterial] = {}
    for mat_cfg in cfg.get("materials", []) or []:
        hm = _make_material(
            mat_cfg, registry, float_tex, rgb_tex, host_mats, allow_multiple_lobes
        )
        if hm is not None:
            mat_ids[hm.name] = mat_builder.add(hm)
            host_mats[hm.name] = hm

    meshes: Dict[str, Dict] = {}
    for obj_cfg in cfg.get("objs", []) or []:
        name = read_string(obj_cfg, "obj_name", "DefaultObjName")
        filename = read_string(obj_cfg, "filename", "DefaultObj")
        to_world = make_to_world(obj_cfg)
        mesh = parse_obj(os.path.join(root_dir, filename))
        meshes[name] = {"mesh": mesh, "to_world": to_world}

    tris, sphs, mediums = _make_aggregate(cfg, meshes, mat_ids)
    world_bound = _world_bound(tris, sphs)

    lights, infinite = _make_lights(cfg, meshes, world_bound, root_dir, registry)

    if spectral:
        used_ids = set(int(t.mat) for t in tris) | set(int(sp_.mat) for sp_ in sphs)
        _check_spectral_subset(mat_builder, mediums, infinite, used_ids)
        lights = _lights_to_spectral(lights)
        infinite = [_env_to_spectral(env) for env in infinite]

    agg_cfg = cfg.get("Aggregate", {}) or {}
    bundle = SceneBundle(
        triangles=_pack_triangles(tris),
        spheres=_pack_spheres(sphs),
        lights=lights,
        materials=mat_builder.pack(n_channels=60 if spectral else 3),
        n_channels=60 if spectral else 3,
        registry=registry,
        dev_images=registry.device_images(),
        infinite=infinite,
        world_bound=world_bound,
        max_prims_in_node=read_i64(agg_cfg, "max_prims_in_node", 4),
        mediums=mediums,
    )

    cam_medium_spec = _parse_medium((cfg.get("Camera", {}) or {}).get("medium"))
    if cam_medium_spec is not None:
        mediums.append(cam_medium_spec)
        bundle.camera_medium = len(mediums) - 1

    film = _make_film_spec(cfg.get("Film", {}))
    camera = _make_camera_spec(cfg.get("Camera", {}))
    sampler = _make_sampler_spec(cfg.get("Sampler", {}))
    return RenderJob(bundle, camera, film, sampler, integrator)


# ---- textures (renderprocess.rs:298-515) ----


def _make_mapping(rec: tex.TexRecord, cfg, to_world: Transform):
    mcfg = cfg.get("mapping")
    if not isinstance(mcfg, dict):
        rec.mapping = tex.MAP_UV
        rec.su = rec.sv = 1.0
        rec.du = rec.dv = 0.0
        return
    kind = read_string(mcfg, "mapping", "uv")
    if kind == "uv":
        rec.mapping = tex.MAP_UV
        rec.su = read_f64(mcfg, "su", 1.0)
        rec.sv = read_f64(mcfg, "sv", 1.0)
        rec.du = read_f64(mcfg, "du", 1.0)
        rec.dv = read_f64(mcfg, "dv", 1.0)
    elif kind == "spherical":
        rec.mapping = tex.MAP_SPHERICAL
        rec.world_to_tex = to_world.m_inv
    elif kind == "cylindrical":
        rec.mapping = tex.MAP_CYLINDRICAL
        rec.world_to_tex = to_world.m_inv
    elif kind == "planar":
        rec.mapping = tex.MAP_PLANAR
        rec.planar_v1 = fetch_xyz(mcfg, "v1", [1.0, 0.0, 0.0])
        rec.planar_v2 = fetch_xyz(mcfg, "v2", [0.0, 1.0, 0.0])
        rec.du = read_f64(mcfg, "udelta", 0.0)
        rec.dv = read_f64(mcfg, "vdelta", 0.0)
    else:
        raise ValueError(f"Unsupported mapping type {kind}")


def _make_textures(cfg, root_dir, registry, float_tex, rgb_tex):
    for is_rgb, section in ((False, "float_texture"), (True, "rgb_texture")):
        table = rgb_tex if is_rgb else float_tex
        for tcfg in cfg.get(section, []) or []:
            to_world = make_to_world(tcfg)
            ttype = read_string(tcfg, "texture_type", "")
            name = read_string(tcfg, "texture_name", "DefaultTextureName")
            rec = tex.TexRecord(kind=tex.TEX_CONSTANT, is_rgb=is_rgb)

            def ref(key, default):
                """Resolve a texture reference with constant fallback
                (get_text_fallback, renderprocess.rs:282-296)."""
                nm = read_string(tcfg, key, "")
                idx = table.get(nm, -1)
                return idx, np.full(3, float(default))

            if ttype == "MixTexture":
                rec.kind = tex.TEX_MIX
                rec.t1, rec.t1_const = ref("t1", 0.0)
                rec.t2, rec.t2_const = ref("t2", 1.0)
                # NOTE: the reference reads the amount texture name from key
                # "t2" (renderprocess.rs:318,411) — a config-parse bug.  We
                # read "amount" and fall back to "t2" for drop-in parity.
                amt_name = read_string(tcfg, "amount", read_string(tcfg, "t2", ""))
                rec.amount = float_tex.get(amt_name, -1)
                rec.amount_const = 0.5
            elif ttype == "BilerpTexture":
                rec.kind = tex.TEX_BILERP
                _make_mapping(rec, tcfg, to_world)
                # reference reads v01 for v10/v11 (renderprocess.rs:328-329);
                # we honour the documented keys.
                if is_rgb:
                    rec.v00 = make_spectrum(tcfg, "v00", 0.0)
                    rec.v01 = make_spectrum(tcfg, "v01", 1.0)
                    rec.v10 = make_spectrum(tcfg, "v10", 0.0)
                    rec.v11 = make_spectrum(tcfg, "v11", 1.0)
                else:
                    rec.v00 = np.full(3, read_f64(tcfg, "v00", 0.0))
                    rec.v01 = np.full(3, read_f64(tcfg, "v01", 1.0))
                    rec.v10 = np.full(3, read_f64(tcfg, "v10", 0.0))
                    rec.v11 = np.full(3, read_f64(tcfg, "v11", 1.0))
            elif ttype == "CheckerBoardTexture":
                dim = read_i64(tcfg, "dimension", 2)
                if dim not in (2, 3):
                    continue
                rec.kind = tex.TEX_CHECKER2D if dim == 2 else tex.TEX_CHECKER3D
                rec.t1, rec.t1_const = ref("t1", 1.0)
                rec.t2, rec.t2_const = ref("t2", 0.0)
                if dim == 2:
                    _make_mapping(rec, tcfg, to_world)
                else:
                    rec.world_to_tex = to_world.m_inv
            elif ttype == "ScaleTexture":
                rec.kind = tex.TEX_SCALE
                rec.t1, rec.t1_const = ref("t1", 1.0)
                rec.t2, rec.t2_const = ref("t2", 1.0)
            elif ttype == "WindyTexture":
                rec.kind = tex.TEX_WINDY
                rec.world_to_tex = to_world.m_inv
            elif ttype == "WrinkledTexture":
                rec.kind = tex.TEX_WRINKLED
                rec.world_to_tex = to_world.m_inv
                rec.octaves = read_i64(tcfg, "octaves", 8)
                rec.omega = read_f64(tcfg, "omega", 0.5)
            elif ttype == "UVTexture" and is_rgb:
                rec.kind = tex.TEX_UV
                _make_mapping(rec, tcfg, to_world)
            elif ttype == "ImageTexture" and is_rgb:
                rec.kind = tex.TEX_IMAGE
                _make_mapping(rec, tcfg, to_world)
                filename = os.path.join(
                    root_dir, read_string(tcfg, "filename", "DefaultTexture")
                )
                wrap = {"black": tex.WRAP_BLACK if False else 1, "clamp": 2}.get(
                    read_string(tcfg, "wrap", "repeat"), 0
                )
                rec.scale = read_f64(tcfg, "scale", 1.0)
                gamma = read_bool(tcfg, "gamma", filename.endswith("png"))
                try:
                    img = _load_image(filename, gamma)
                except OSError:
                    continue
                from .mipmap import build_mipmap

                rec.image_id = registry.add_image(
                    build_mipmap(
                        img,
                        wrap=wrap,
                        do_trilinear=read_bool(tcfg, "do_trilinear", False),
                        max_aniso=read_f64(tcfg, "max_aniso", 8.0),
                    )
                )
            else:
                continue  # unsupported type: skip like the reference
            table[name] = registry.add(rec)


def _load_image(filename, gamma):
    """PNG -> linear float rows flipped so v=0 is the bottom row
    (renderprocess.rs:535-569)."""
    img = read_png(filename)
    # gray -> RGB; alpha is dropped
    img = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3]
    img = img.astype(np.float64) / 255.0
    if gamma:
        img = np.where(
            img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
        )
    return img[::-1]


# ---- materials (renderprocess.rs:664-871) ----


def _rgb_param(cfg, registry, rgb_tex, key, default) -> RGBParam:
    """Material rgb parameter: a texture name (renderprocess.rs:288-294
    semantics — unknown names fall back to the default constant), or —
    extension over the reference schema, which has no constant-texture
    config type — an inline constant (number, [r,g,b], or
    {"values": [r,g,b]})."""
    nm = cfg.get(key)
    if isinstance(nm, str) and nm in rgb_tex:
        return RGBParam(np.zeros(3), rgb_tex[nm])
    if isinstance(nm, dict) and "values" in nm:
        nm = nm["values"]
    if isinstance(nm, (int, float, list)):
        return RGBParam(np.asarray(nm, np.float64) * np.ones(3), -1)
    return RGBParam(np.asarray(default, np.float64) * np.ones(3), -1)


def _float_param(cfg, registry, float_tex, key, default) -> Optional[FloatParam]:
    """Float parameter: texture name, inline numeric constant (extension),
    or the default."""
    nm = cfg.get(key)
    if isinstance(nm, str) and nm in float_tex:
        return FloatParam(0.0, float_tex[nm])
    if isinstance(nm, (int, float)) and not isinstance(nm, bool):
        return FloatParam(float(nm), -1)
    if default is None:
        return None
    return FloatParam(float(default), -1)


def _make_material(cfg, registry, float_tex, rgb_tex, host_mats, allow_multiple_lobes):
    mtype = read_string(cfg, "material_type", "")
    name = read_string(cfg, "material_name", "DefaultMaterialName")
    bump = _float_param(cfg, registry, float_tex, "bump_map", None)
    bump_tex = bump.tex if bump is not None else -1
    remap = read_bool(cfg, "remap_roughness", False)
    R = lambda key, d: _rgb_param(cfg, registry, rgb_tex, key, d)
    F = lambda key, d: _float_param(cfg, registry, float_tex, key, d)

    if mtype == "MatteMaterial":
        return recipes.matte(name, R("kd", 0.5), F("sigma", 0.0), bump_tex)
    if mtype == "PlasticMaterial":
        return recipes.plastic(name, R("kd", 0.25), R("ks", 0.25), F("roughness", 0.1), remap, bump_tex)
    if mtype == "MetalMaterial":
        eta = R("eta", COPPER_N_RGB)
        k = R("k", COPPER_K_RGB)
        return recipes.metal(
            name, eta, k, F("roughness", 0.01),
            F("u_roughness", None), F("v_roughness", None), remap, bump_tex,
        )
    if mtype == "MirrorMaterial":
        return recipes.mirror(name, R("kr", 0.9), bump_tex)
    if mtype == "GlassMaterial":
        return recipes.glass(
            name, R("kr", 1.0), R("kt", 1.0),
            F("u_roughness", 0.0), F("v_roughness", 0.0), F("eta", 1.5),
            remap, allow_multiple_lobes, bump_tex,
        )
    if mtype == "TranslucentMaterial":
        return recipes.translucent(
            name, R("kd", 0.25), R("ks", 0.25), F("roughness", 0.1),
            R("reflect", 0.25), R("transmit", 0.25), remap, bump_tex,
        )
    if mtype == "MixMaterial":
        m1 = host_mats.get(read_string(cfg, "mat1", ""))
        m2 = host_mats.get(read_string(cfg, "mat2", ""))
        if m1 is None or m2 is None:
            return None
        return recipes.mix(name, m1, m2, R("scale", 0.5))
    if mtype == "DisneyMaterial":
        return recipes.disney(
            name,
            R("color", 0.5),
            F("metallic", 0.0),
            F("eta", 1.5),
            F("roughness", 0.5),
            F("specular_tint", 0.0),
            F("anisotropic", 0.0),
            F("sheen", 0.0),
            F("sheen_tint", 0.5),
            F("clearcoat", 0.0),
            F("clearcoat_gloss", 1.0),
            F("spec_trans", 0.0),
            R("scatter_distance", 0.0),
            read_bool(cfg, "thin", False),
            F("flatness", 0.0),
            F("diff_trans", 1.0),
            bump_tex,
        )
    if mtype == "Debug":
        return recipes.debug(name)
    return None


# ---- aggregate (renderprocess.rs:1178-1304) ----


@dataclass
class _TriInstance:
    p: np.ndarray  # (3,3) world-space vertices
    n: Optional[np.ndarray]  # (3,3) shading normals or None
    uv: Optional[np.ndarray]  # (3,2) or None
    mat: int
    area_light: int = -1
    med_in: int = -1
    med_out: int = -1


@dataclass
class _SphereInstance:
    o2w: np.ndarray
    radius: float
    z_min: float
    z_max: float
    phi_max_deg: float
    mat: int
    area_light: int = -1
    med_in: int = -1
    med_out: int = -1


def _sphere_from_cfg(cfg, extra_to_world: Optional[Transform] = None):
    to_world = make_to_world(cfg)
    if extra_to_world is not None:
        to_world = extra_to_world * to_world
    radius = read_f64(cfg, "radius", 1.0)
    return _SphereInstance(
        o2w=to_world.m,
        radius=radius,
        z_min=read_f64(cfg, "z_min", -radius),
        z_max=read_f64(cfg, "z_max", radius),
        phi_max_deg=read_f64(cfg, "phi_max", 360.0),
        mat=-1,
    )


def _expand_mesh(mesh_entry, instance_to_world: Optional[Transform], mat_id):
    """GeometricPrimitive per triangle, optionally instanced
    (TransformedPrimitive, primitives.rs:115-140) — baked to world space."""
    mesh: ObjMesh = mesh_entry["mesh"]
    base: Transform = mesh_entry["to_world"]
    xf = instance_to_world * base if instance_to_world is not None else base
    p = xf.apply_point(mesh.p)
    has_n = mesh.normal_indices.size > 0 and mesh.n.size > 0
    n_world = xf.apply_normal(mesh.n) if has_n else None
    has_uv = mesh.uv_indices.size > 0 and mesh.uv.size > 0
    out = []
    vi = mesh.vertex_indices.reshape(-1, 3)
    ni = mesh.normal_indices.reshape(-1, 3) if has_n else None
    ti = mesh.uv_indices.reshape(-1, 3) if has_uv else None
    for t in range(mesh.n_triangles):
        out.append(
            _TriInstance(
                p=p[vi[t]],
                n=n_world[ni[t]] if has_n else None,
                uv=mesh.uv[ti[t]] if has_uv else None,
                mat=mat_id,
            )
        )
    return out


def _parse_medium(mcfg) -> Optional[MediumSpec]:
    """(renderprocess.rs:1135-1176)"""
    if not isinstance(mcfg, dict):
        return None
    mtype = read_string(mcfg, "medium_type", "")
    # preset lookup (get_medium_scattering_properties,
    # renderprocess.rs:1108-1133)
    sigma_a, sigma_s = _DEFAULT_SIGMA_A, _DEFAULT_SIGMA_S
    preset = read_string(mcfg, "preset", "")
    if preset:
        from .subsurface_presets import SUBSURFACE_PARAMETER_TABLE

        if preset in SUBSURFACE_PARAMETER_TABLE:
            ss, sa = SUBSURFACE_PARAMETER_TABLE[preset]
            sigma_s = np.asarray(ss)
            sigma_a = np.asarray(sa)
    g = read_f64(mcfg, "g", 0.0)
    to_world = make_to_world(mcfg)
    if mtype == "Homogeneous":
        return MediumSpec("homogeneous", sigma_a, sigma_s, g)
    if mtype == "GridDensity":
        nx = read_i64(mcfg, "nx", 1)
        ny = read_i64(mcfg, "ny", nx)
        nz = read_i64(mcfg, "nz", nx)
        d = np.asarray(mcfg.get("d", []), np.float64)
        p0 = fetch_xyz(mcfg, "p0", [0.0, 0.0, 0.0])
        p1 = fetch_xyz(mcfg, "p1", [1.0, 1.0, 1.0])
        data2medium = Transform.translate(p0) * Transform.scale(
            p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]
        )
        w2m = (to_world.inverse() * data2medium).m
        return MediumSpec(
            "grid", sigma_a, sigma_s, g, nx, ny, nz, d.reshape(nz, ny, nx), w2m
        )
    return None


def _make_aggregate(cfg, meshes, mat_ids):
    agg = cfg.get("Aggregate", {}) or {}
    tris: List[_TriInstance] = []
    sphs: List[_SphereInstance] = []
    mediums: List[MediumSpec] = []
    def parse_mi(prim):
        """Per-primitive medium interface (renderprocess.rs:1193-1207)."""
        mi_cfg = prim.get("medium_interface")
        med_in = med_out = -1
        if isinstance(mi_cfg, dict):
            mspec = _parse_medium(mi_cfg.get("inside"))
            if mspec is not None:
                mediums.append(mspec)
                med_in = len(mediums) - 1
            mspec = _parse_medium(mi_cfg.get("outside"))
            if mspec is not None:
                mediums.append(mspec)
                med_out = len(mediums) - 1
        return med_in, med_out

    for prim in agg.get("primitives", []) or []:
        ptype = read_string(prim, "primitive_type", "")
        mat_name = read_string(prim, "material_name", "DefaultMaterialName")
        mat_id = mat_ids.get(mat_name, -1)
        med_in, med_out = parse_mi(prim)
        if ptype == "sphere":
            if mat_id < 0:
                continue
            instances = prim.get("instances")
            base = _sphere_from_cfg(prim)
            if isinstance(instances, list):
                for inst in instances:
                    s = _sphere_from_cfg(prim, make_to_world(inst))
                    s.mat = mat_id
                    s.med_in, s.med_out = med_in, med_out
                    sphs.append(s)
            else:
                base.mat = mat_id
                base.med_in, base.med_out = med_in, med_out
                sphs.append(base)
        elif ptype == "triangle":
            obj_name = read_string(prim, "obj_name", "DefaultObjName")
            if obj_name not in meshes or mat_id < 0:
                continue
            instances = prim.get("instances")
            new_tris = []
            if isinstance(instances, list):
                for inst in instances:
                    new_tris.extend(
                        _expand_mesh(meshes[obj_name], make_to_world(inst), mat_id)
                    )
            else:
                new_tris.extend(_expand_mesh(meshes[obj_name], None, mat_id))
            for t in new_tris:
                t.med_in, t.med_out = med_in, med_out
            tris.extend(new_tris)
    return tris, sphs, mediums


def _pack_triangles(tris: List[_TriInstance]) -> TriangleSoA:
    t = max(len(tris), 0)
    if t == 0:
        from .types import empty_triangles

        return empty_triangles()
    p = np.stack([x.p for x in tris])  # (T,3,3)
    has_n = np.array([x.n is not None for x in tris])
    n = np.stack([x.n if x.n is not None else np.zeros((3, 3)) for x in tris])
    default_uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    uv = np.stack([x.uv if x.uv is not None else default_uv for x in tris])
    # bake ray-independent shading geometry (triangle.rs:276-299) in f64
    dp02 = p[:, 0] - p[:, 2]
    dp12 = p[:, 1] - p[:, 2]
    ng = np.cross(dp02, dp12)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-30)
    duv02 = uv[:, 0] - uv[:, 2]
    duv12 = uv[:, 1] - uv[:, 2]
    deter = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degen = np.abs(deter) < 1e-8
    idet = 1.0 / np.where(degen, 1.0, deter)
    dpdu = (dp02 * duv12[:, 1:2] - dp12 * duv02[:, 1:2]) * idet[:, None]
    dpdv = (-dp02 * duv12[:, 0:1] + dp12 * duv02[:, 0:1]) * idet[:, None]
    # degenerate-uv fallback: coordinate system around ng
    if degen.any():
        from ..core import vec as _vec
        fb1, fb2 = _vec.coordinate_system(jnp.asarray(ng[degen], DTYPE))
        dpdu[degen] = np.asarray(fb1)
        dpdv[degen] = np.asarray(fb2)
    f32 = lambda a: jnp.asarray(a, DTYPE)
    return TriangleSoA(
        p0=f32(p[:, 0]), p1=f32(p[:, 1]), p2=f32(p[:, 2]),
        n0=f32(n[:, 0]), n1=f32(n[:, 1]), n2=f32(n[:, 2]),
        uv0=f32(uv[:, 0]), uv1=f32(uv[:, 1]), uv2=f32(uv[:, 2]),
        has_n=jnp.asarray(has_n),
        mat=jnp.asarray([x.mat for x in tris], jnp.int32),
        area_light=jnp.asarray([x.area_light for x in tris], jnp.int32),
        med_in=jnp.asarray([x.med_in for x in tris], jnp.int32),
        med_out=jnp.asarray([x.med_out for x in tris], jnp.int32),
        ng=f32(ng),
        dpdu=f32(dpdu),
        dpdv=f32(dpdv),
    )


def _pack_spheres(sphs: List[_SphereInstance]) -> SphereSoA:
    if not sphs:
        from .types import empty_spheres

        return empty_spheres()
    o2w = np.stack([s.o2w for s in sphs])
    w2o = np.stack([np.linalg.inv(s.o2w) for s in sphs])
    radius = np.array([s.radius for s in sphs])
    z_min = np.clip(np.minimum([s.z_min for s in sphs], [s.z_max for s in sphs]), -radius, radius)
    z_max = np.clip(np.maximum([s.z_min for s in sphs], [s.z_max for s in sphs]), -radius, radius)
    theta_min = np.arccos(np.clip(z_min / radius, -1, 1))
    theta_max = np.arccos(np.clip(z_max / radius, -1, 1))
    phi_max = np.deg2rad(np.clip([s.phi_max_deg for s in sphs], 0.0, 360.0))
    f32 = lambda a: jnp.asarray(a, DTYPE)
    return SphereSoA(
        o2w=f32(o2w), w2o=f32(w2o), radius=f32(radius),
        z_min=f32(z_min), z_max=f32(z_max),
        theta_min=f32(theta_min), theta_max=f32(theta_max), phi_max=f32(phi_max),
        mat=jnp.asarray([s.mat for s in sphs], jnp.int32),
        area_light=jnp.asarray([s.area_light for s in sphs], jnp.int32),
        med_in=jnp.asarray([s.med_in for s in sphs], jnp.int32),
        med_out=jnp.asarray([s.med_out for s in sphs], jnp.int32),
    )


def _world_bound(tris, sphs):
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for t in tris:
        lo = np.minimum(lo, t.p.min(axis=0))
        hi = np.maximum(hi, t.p.max(axis=0))
    for s in sphs:
        # conservative: transform object-space AABB corners
        r = s.radius
        corners = np.array(
            [[x, y, z] for x in (-r, r) for y in (-r, r) for z in (-r, r)]
        )
        wc = corners @ s.o2w[:3, :3].T + s.o2w[:3, 3]
        lo = np.minimum(lo, wc.min(axis=0))
        hi = np.maximum(hi, wc.max(axis=0))
    if not np.all(np.isfinite(lo)):
        lo = np.zeros(3)
        hi = np.zeros(3)
    return np.stack([lo, hi])


# ---- lights (renderprocess.rs:921-1053) ----


def _make_lights(cfg, meshes, world_bound, root_dir, registry):
    entries = []
    infinite_dev = []
    center = 0.5 * (world_bound[0] + world_bound[1])
    radius = float(np.linalg.norm(world_bound[1] - center))

    def parse_one(lcfg, is_infinite_section):
        # "infinite_lights"-section lights are escape-le only; "lights"-
        # section lights are what NEE samples (scene.rs keeps two vecs;
        # uniform_sample_* reads scene.lights, path.rs escape reads
        # scene.infinite_lights)
        ltype = read_string(lcfg, "light_type", "")
        to_world = make_to_world(lcfg)
        if ltype == "point":
            # PointLight::new(light_to_world, ..., Point3f::default(), i):
            # position = to_world applied to the origin
            p = to_world.apply_point(np.zeros(3))
            entries.append(
                dict(kind=LIGHT_POINT, p=p, emit=make_spectrum(lcfg, "spectrum", 1.0))
            )
        elif ltype == "distant":
            l = make_spectrum(lcfg, "l", 1.0)
            sc = make_spectrum(lcfg, "scale", 1.0)
            frm = fetch_xyz(lcfg, "from", [0.0, 0.0, 0.0])
            to = fetch_xyz(lcfg, "to", [0.0, 0.0, 1.0])
            d = frm - to  # lights/distant.rs w_light = normalize(to_world.t(dir))
            d = to_world.apply_vector(d)
            d = d / np.linalg.norm(d)
            entries.append(dict(kind=LIGHT_DISTANT, emit=l * sc, w=d))
        elif ltype == "diffuse":
            lemit = make_spectrum(lcfg, "spectrum", 1.0)
            n_samples = read_i64(lcfg, "n_samples", 1)
            shape_cfg = lcfg.get("light_shape")
            if not isinstance(shape_cfg, dict):
                raise ValueError("Shape required for a DiffuseLight")
            stype = read_string(shape_cfg, "shape_type", "")
            if stype == "sphere":
                sph = _sphere_from_cfg(shape_cfg)
                # full-sphere area; partial-sphere lights are clipped at
                # sampling time (rare; sphere.rs area() uses full formula)
                area = 4.0 * np.pi * sph.radius**2
                entries.append(
                    dict(
                        kind=LIGHT_DIFFUSE_AREA,
                        emit=lemit,
                        n_samples=n_samples,
                        shape_kind=AREA_SHAPE_SPHERE,
                        sphere=sph,
                        area=area,
                    )
                )
            elif stype == "triangle":
                obj_name = read_string(shape_cfg, "obj_name", "")
                tri_num = read_i64(shape_cfg, "tri_num", 0)
                mesh_entry = meshes[obj_name]
                tri = _expand_mesh(mesh_entry, None, -1)[tri_num]
                area = 0.5 * np.linalg.norm(
                    np.cross(tri.p[1] - tri.p[0], tri.p[2] - tri.p[0])
                )
                entries.append(
                    dict(
                        kind=LIGHT_DIFFUSE_AREA,
                        emit=lemit,
                        n_samples=n_samples,
                        shape_kind=AREA_SHAPE_TRIANGLE,
                        tri=tri,
                        area=area,
                    )
                )
        elif ltype == "infinite":
            l = make_spectrum(lcfg, "l", 1.0)
            sc = make_spectrum(lcfg, "scale", 1.0)
            texmap = read_string(lcfg, "mapname", "")
            n_samples = read_i64(lcfg, "n_samples", 1)
            env = _build_env_map(
                os.path.join(root_dir, texmap) if texmap else "", to_world
            )
            env["escape_le"] = is_infinite_section
            if is_infinite_section:
                # escape-le only (scene.infinite_lights; path.rs:84-87)
                infinite_dev.append(env)
            else:
                env_id = len(infinite_dev)
                infinite_dev.append(env)
                entries.append(
                    dict(
                        kind=LIGHT_INFINITE,
                        emit=l * sc,
                        n_samples=n_samples,
                        env_id=env_id,
                    )
                )

    for lcfg in cfg.get("lights", []) or []:
        parse_one(lcfg, False)
    for lcfg in cfg.get("infinite_lights", []) or []:
        parse_one(lcfg, True)

    return _pack_lights(entries, center, radius, infinite_dev), infinite_dev


def _build_env_map(texmap_path, to_world: Transform):
    """InfiniteAreaLight construction (lights/infinite.rs:34-112): 8-bit
    PNG -> reflectance spectra (rows flipped), MIPMap, and a Distribution2D
    over luminance * sin(theta) at 2x map resolution."""
    from ..core.sampling import Distribution2D
    from .mipmap import build_mipmap

    if texmap_path and os.path.exists(texmap_path):
        img = _load_image(texmap_path, gamma=True)
    else:
        img = np.ones((8, 8, 3), np.float64)
    mip = build_mipmap(img, wrap=0)
    h2, w2 = 2 * mip.height, 2 * mip.width
    # luminance * sin(theta) at the distribution resolution
    base = mip.levels[0].astype(np.float64)
    vs = (np.arange(h2) + 0.5) / h2
    us = (np.arange(w2) + 0.5) / w2
    # nearest-sample the base level (fwidth lookup in the reference is a
    # mip-filtered read; the 2x oversampling makes the difference moot)
    vi = np.clip((vs * base.shape[0]).astype(int), 0, base.shape[0] - 1)
    ui = np.clip((us * base.shape[1]).astype(int), 0, base.shape[1] - 1)
    lum = (
        0.212671 * base[..., 0] + 0.715160 * base[..., 1] + 0.072169 * base[..., 2]
    )
    func = lum[np.ix_(vi, ui)] * np.sin(np.pi * vs)[:, None]
    dist = Distribution2D(func.ravel(), w2, h2)
    return {
        "mipmap": mip.as_device(),
        "dist": dist.as_device(),
        "to_world": jnp.asarray(to_world.m, DTYPE),
        "to_local": jnp.asarray(to_world.m_inv, DTYPE),
    }


def _pack_lights(entries, center, radius, infinite_dev):
    L = len(entries)
    kind = np.zeros(L, np.int32)
    p = np.zeros((L, 3))
    emit = np.zeros((L, 3))
    w = np.zeros((L, 3))
    shape_kind = np.full(L, AREA_SHAPE_NONE, np.int32)
    shape_index = np.full(L, -1, np.int32)
    n_samples = np.ones(L, np.int32)
    sph_o2w = np.tile(np.eye(4), (L, 1, 1))
    sph_w2o = np.tile(np.eye(4), (L, 1, 1))
    sph_radius = np.ones(L)
    tri_p = np.zeros((L, 3, 3))
    area = np.ones(L)
    from .types import LightSoA

    for i, e in enumerate(entries):
        kind[i] = e["kind"]
        emit[i] = e["emit"]
        n_samples[i] = e.get("n_samples", 1)
        if e["kind"] == LIGHT_POINT:
            p[i] = e["p"]
        elif e["kind"] == LIGHT_DISTANT:
            w[i] = e["w"]
        elif e["kind"] == LIGHT_DIFFUSE_AREA:
            shape_kind[i] = e["shape_kind"]
            area[i] = e["area"]
            if e["shape_kind"] == AREA_SHAPE_SPHERE:
                sph_o2w[i] = e["sphere"].o2w
                sph_w2o[i] = np.linalg.inv(e["sphere"].o2w)
                sph_radius[i] = e["sphere"].radius
            else:
                tri_p[i] = e["tri"].p
        elif e["kind"] == LIGHT_INFINITE:
            shape_index[i] = e.get("env_id", -1)

    f32 = lambda a: jnp.asarray(a, DTYPE)
    return LightSoA(
        kind=jnp.asarray(kind),
        p=f32(p),
        emit=f32(emit),
        w_light=f32(w),
        world_center=f32(center),
        world_radius=jnp.asarray(radius, DTYPE),
        shape_kind=jnp.asarray(shape_kind),
        shape_index=jnp.asarray(shape_index),
        n_samples=jnp.asarray(n_samples),
        two_sided=jnp.zeros(L, bool),
        sph_o2w=f32(sph_o2w),
        sph_w2o=f32(sph_w2o),
        sph_radius=f32(sph_radius),
        tri_p=f32(tri_p),
        area=f32(area),
    )


# ---- driver specs (renderprocess.rs:1306-1499) ----


def _make_film_spec(fcfg) -> FilmSpec:
    filter_cfg = fcfg.get("Filter", {}) or {}
    ftype = read_string(filter_cfg, "filter_type", "BoxFilter")
    if ftype == "TriangleFilter":
        radius = fetch_vector2(filter_cfg, "radius", [2.0, 2.0])
    elif ftype == "GaussianFilter":
        radius = fetch_vector2(filter_cfg, "radius", [2.0, 2.0])
    else:
        ftype = "BoxFilter"
        radius = fetch_vector2(filter_cfg, "radius", [0.5, 0.5])
    return FilmSpec(
        xres=read_i64(fcfg, "xres", 1280),
        yres=read_i64(fcfg, "yres", 720),
        diagonal_mm=read_f64(fcfg, "diagonal", 35.0),
        scale=read_f64(fcfg, "scale", 1.0),
        max_sample_luminance=read_f64(fcfg, "max_sample_luminance", float("inf")),
        filter_type=ftype,
        filter_radius=radius,
        gaussian_alpha=read_f64(filter_cfg, "alpha", 2.0),
    )


def _make_camera_spec(ccfg) -> CameraSpec:
    world_pos = fetch_xyz(ccfg, "world_pos", [0.0, 0.0, 0.0])
    look = fetch_xyz(ccfg, "look", [1.0, 1.0, 1.0])
    up = fetch_xyz(ccfg, "up", [0.0, 0.0, 1.0])
    to_camera = Transform.look_at(world_pos, look, up)
    lens_data = np.asarray(ccfg.get("lens_data", []), np.float64)
    return CameraSpec(
        cam_to_world=to_camera.inverse(),
        shutter_open=read_f64(ccfg, "shutter_open", 0.0),
        shutter_close=read_f64(ccfg, "shutter_close", 1.0),
        aperture_diameter=read_f64(ccfg, "aperture_diameter", 1.0),
        focus_distance=read_f64(ccfg, "focus_distance", 10.0),
        simple_weighting=read_bool(ccfg, "simple_weighting", True),
        lens_data=lens_data,
    )


def _make_sampler_spec(scfg) -> SamplerSpec:
    kind = read_string(scfg, "sampler_type", "")
    if kind == "HaltonSampler":
        return SamplerSpec(
            kind="halton",
            nsamp=read_i64(scfg, "nsamp", 16),
            sample_at_center=read_bool(scfg, "sample_at_center", False),
        )
    return SamplerSpec(
        kind="stratified",
        jitter=read_bool(scfg, "jitter", True),
        xsamp=read_i64(scfg, "xsamp", 4),
        ysamp=read_i64(scfg, "ysamp", 4),
        dimension=read_i64(scfg, "dimension", 4),
    )


def _make_integrator_spec(icfg) -> IntegratorSpec:
    kind = read_string(icfg, "integrator_type", "AO")
    mapping = {
        "DirectLighting": "direct",
        "Path": "path",
        "Volpath": "volpath",
        "SPPM": "sppm",
        "Debug": "debug",
    }
    return IntegratorSpec(
        kind=mapping.get(kind, "ao"),
        max_depth=read_i64(icfg, "max_depth", 5),
        light_strategy=read_string(icfg, "light_strategy", "one"),
        rr_threshold=read_f64(icfg, "rr_threshold", 1.0),
        cos_sample=read_bool(icfg, "cos_sample", True),
        n_samples=read_i64(icfg, "n_samples", 64),
        radius=read_f64(icfg, "radius", 1.0),
        n_iters=read_i64(icfg, "n_iters", 5),
        photons_per_iter=read_i64(icfg, "photons_per_iter", 1),
        write_freq=read_i64(icfg, "write_freq", 1 << 31),
    )


# ---- sampled-spectral mode helpers (main.rs:45-49 config axis) ----


def _check_spectral_subset(mat_builder, mediums, infinite, used_ids):
    """Validate the spectral mode's subset — loud failure beats silently
    wrong colors.  Round 3 lifted media (sigma spectra), infinite lights
    (env maps), textured params (device from_rgb per hit), debug
    materials, bump mapping, the Disney BSSRDF (R/scatter_distance
    lifted in lobes.py pack; profile/pdf machinery is channel-count
    generic), and SPPM (C-channel ld/tau/phi state).  No gates remain —
    this hook is kept for future subset regressions."""


def _env_to_spectral(env):
    """Lift an env map's radiance pyramid (L,H,W,3) -> (L,H,W,60).

    The reference's InfiniteAreaLight texels are reconstructed with the
    REFLECTANCE Smits basis (infinite.rs:65); from_rgb is linear, so
    lifting the mip levels equals building the pyramid from lifted
    texels.  The sampling distribution stays luminance-based (built from
    RGB before the lift)."""
    from ..core import spectral as sp

    out = dict(env)
    mip = dict(env["mipmap"])
    # device pyramid is channel-folded (L, Hp, Wp*3); unfold, lift RGB
    # -> N=60 on the trailing axis, refold -> (L, Hp, Wp*60)
    d = mip["data"]
    l_, hp, wpc = d.shape
    unf = d.reshape(l_, hp, wpc // 3, 3)
    lifted = sp.from_rgb(unf, sp.REFLECTANCE)
    mip["data"] = lifted.reshape(l_, hp, -1)
    mip["channels"] = lifted.shape[-1]
    out["mipmap"] = mip
    return out


def _lights_to_spectral(lights):
    """Lift the light emission table (L,3) -> (L,60) via the Smits
    illuminant basis (spectrum.rs from_rgb SpectrumType::Illuminant)."""
    import dataclasses

    from ..core import spectral as sp

    emit60 = sp.from_rgb(jnp.asarray(np.asarray(lights.emit), jnp.float32), sp.ILLUMINANT)
    return dataclasses.replace(lights, emit=emit60)
