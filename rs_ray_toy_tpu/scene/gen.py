"""Scenes generated from constants: the base scene and benchmark scenes.

`write_base_scene` writes the canonical 36-triangle scene (`samples/` in
the repository holds its output): three instances of a 12-triangle cube
lit by three point lights, seen through a realistic lens that looks down
+x at about 35 units, in the reference's JSON schema.

The other generators derive benchmark scenes from it.  `write_grid_scene`
tiles the cube into an n x n instance grid in front of the camera,
producing scenes of 10^4..10^5 triangles through the same `instances`
config path the reference parses (renderprocess.rs:1214-1282)."""

import json
import os
import shutil

import numpy as np

from ..utils.png import encode_png

SAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "samples",
)
BASE_SCENE = os.path.join(SAMPLES_DIR, "scene.json")

# Double Gauss 50 mm f/2 (US patent 2,673,491, Tronnier; Modern Lens
# Design p. 312, scaled to 50 mm), as the lens file dgauss.50mm.dat that
# ships with PBRT-v3's scenes.  Rows are (curvature radius, thickness,
# index of refraction, aperture diameter) in mm, front (scene side) to
# rear; the row with radius 0 is the aperture stop.
DGAUSS_50MM = (
    (29.475, 3.76, 1.67, 25.2),
    (84.83, 0.12, 1.0, 25.2),
    (19.275, 4.025, 1.67, 23.0),
    (40.77, 3.275, 1.699, 23.0),
    (12.75, 5.705, 1.0, 18.0),
    (0.0, 4.5, 0.0, 17.1),
    (-14.495, 1.18, 1.603, 17.0),
    (40.77, 6.065, 1.658, 20.0),
    (-20.385, 0.19, 1.0, 20.0),
    (437.065, 3.22, 1.717, 20.0),
    (-39.73, 5.0, 1.0, 20.0),
)

# (world_pos, scale, rotation_axis, rotation_angle) of the three cubes
CUBE_INSTANCES = (
    ((35.2, -1.3, 0.4), 1.0, (0.3, 1.0, 0.2), 35.0),
    ((36.5, 1.6, 2.9), 0.9, (1.0, 0.0, 1.0), 20.0),
    ((34.0, 3.0, -1.8), 0.8, (0.0, 1.0, 1.0), 50.0),
)

# white, pink and cyan point lights between the camera and the cubes
POINT_LIGHTS = (
    ((29.0, -5.0, 6.0), (120.0, 120.0, 120.0)),
    ((30.0, 6.0, 3.0), (120.0, 50.0, 90.0)),
    ((31.0, 0.0, -6.0), (40.0, 110.0, 120.0)),
)

TEXTURE_SEED = 1
TEXTURE_SIZE = 256

# Camera medium for the fog scenes.  The loader's preset-free default
# (sigma_s about 3 per unit) leaves a camera 35 units deep in it a black
# image; the Clorox preset (sigma_t 0.006-0.030 per unit, albedo
# 0.13-0.42) passes 35-82% of the light over that distance and scatters
# enough of the point lights' to show the fog itself.
FOG_MEDIUM = {"medium_type": "Homogeneous", "g": 0.0, "preset": "Clorox"}


def _cube_obj():
    """The +-1 cube: 8 vertices, per-face normals, each face mapped to the
    whole [0,1]^2 texture, two triangles per face."""
    corners = [
        (x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)
    ]
    idx = {c: i + 1 for i, c in enumerate(corners)}
    lines = ["# unit cube: 12 triangles"]
    lines += [f"v {x:.1f} {y:.1f} {z:.1f}" for x, y, z in corners]
    lines += ["vt 0.0 0.0", "vt 1.0 0.0", "vt 1.0 1.0", "vt 0.0 1.0"]
    faces = []
    for axis in range(3):
        for sign in (-1, 1):
            n = [0, 0, 0]
            n[axis] = sign
            lines.append("vn {:.1f} {:.1f} {:.1f}".format(*n))
            u_ax, v_ax = [a for a in range(3) if a != axis]
            quad = []
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                c = [0, 0, 0]
                c[axis], c[u_ax], c[v_ax] = sign, du, dv
                quad.append(idx[tuple(c)])
            # counter-clockwise seen from outside: u x v is +axis except
            # for the y faces, where (x, z) gives -y
            if sign * (-1 if axis == 1 else 1) < 0:
                quad = [quad[0], quad[3], quad[2], quad[1]]
            faces.append(quad)
    for f, quad in enumerate(faces):
        vn = f + 1
        tv = (1, 2, 3, 4)
        for a, b, c in ((0, 1, 2), (0, 2, 3)):
            lines.append(
                "f " + " ".join(
                    f"{quad[k]}/{tv[k]}/{vn}" for k in (a, b, c)
                )
            )
    return "\n".join(lines) + "\n"


def _texture_image():
    """Procedural 256x256 RGB texture: smooth color waves over an 8x8
    checker, plus seeded noise."""
    n = TEXTURE_SIZE
    y, x = (np.mgrid[0:n, 0:n] + 0.5) / n
    waves = np.stack(
        [
            0.5 + 0.5 * np.sin(2 * np.pi * 3 * x),
            0.5 + 0.5 * np.sin(2 * np.pi * (2 * y + x)),
            0.5 + 0.5 * np.cos(2 * np.pi * 4 * y),
        ],
        -1,
    )
    checker = ((np.floor(8 * x) + np.floor(8 * y)) % 2)[..., None]
    noise = np.random.default_rng(TEXTURE_SEED).random((n, n, 3))
    img = 0.6 * waves + 0.25 * checker + 0.15 * noise
    return np.clip(np.round(255.0 * img), 0, 255).astype(np.uint8)


def base_scene_config():
    """The base scene as a JSON-ready dict (the reference's schema)."""
    return {
        "float_texture": [],
        "rgb_texture": [
            {
                "texture_type": "ImageTexture",
                "texture_name": "s_01",
                "filename": "s_01.png",
            }
        ],
        "materials": [
            {"material_type": "MatteMaterial", "material_name": "mat_matte"},
            {"material_type": "PlasticMaterial", "material_name": "mat_plastic"},
            {"material_type": "MetalMaterial", "material_name": "mat_metal"},
        ],
        "objs": [{"obj_name": "cube_01", "filename": "cube.obj"}],
        "lights": [
            {
                "light_type": "point",
                "world_pos": list(pos),
                "spectrum": {"values": list(rgb)},
            }
            for pos, rgb in POINT_LIGHTS
        ],
        "Aggregate": {
            "max_prims_in_node": 4,
            "primitives": [
                {
                    "primitive_type": "triangle",
                    "obj_name": "cube_01",
                    "material_name": "mat_matte",
                    "instances": [
                        {
                            "world_pos": list(pos),
                            "scale": [s, s, s],
                            "rotation_axis": list(axis),
                            "rotation_angle": angle,
                        }
                        for pos, s, axis, angle in CUBE_INSTANCES
                    ],
                }
            ],
        },
        "Integrator": {"integrator_type": "Debug", "max_depth": 5},
        "Sampler": {
            "sampler_type": "StratifiedSampler",
            "xsamp": 4,
            "ysamp": 4,
            "jitter": True,
            "dimension": 4,
        },
        "Film": {
            "xres": 640,
            "yres": 360,
            "diagonal": 35.0,
            "Filter": {"filter_type": "BoxFilter", "radius": [0.5, 0.5]},
        },
        "Camera": {
            "world_pos": [0.0, 0.0, 0.0],
            "look": [1.0, 0.0, 0.0],
            "up": [0.0, 0.0, 1.0],
            "lens_data": [v for row in DGAUSS_50MM for v in row],
            "aperture_diameter": 8.0,
            "focus_distance": 35.0,
            "simple_weighting": True,
        },
    }


def write_base_scene(out_dir):
    """Write scene.json, cube.obj and s_01.png under out_dir; returns the
    scene.json path.  The output is byte-identical to `samples/`."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cube.obj"), "w") as fh:
        fh.write(_cube_obj())
    with open(os.path.join(out_dir, "s_01.png"), "wb") as fh:
        fh.write(encode_png(_texture_image()))
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as fh:
        fh.write(json.dumps(base_scene_config(), indent=2) + "\n")
    return path


def write_grid_scene(
    out_dir,
    ny=40,
    nz=40,
    base=BASE_SCENE,
    integrator="Path",
    max_depth=5,
    span_y=6.0,
    span_z=4.0,
    xres=None,
    yres=None,
    material=None,
):
    """Write grid.json (+ cube.obj) under out_dir; returns the json path.

    ny*nz cube instances -> 12*ny*nz triangles.
    """
    cfg = json.load(open(base))
    if xres:
        cfg["Film"]["xres"] = xres
    if yres:
        cfg["Film"]["yres"] = yres
    cfg["Integrator"] = {"integrator_type": integrator, "max_depth": max_depth}
    prim = cfg["Aggregate"]["primitives"][0]
    if material:
        prim["material_name"] = material
    # cube.obj spans +-1: scale so neighbours don't touch
    sy = span_y / ny
    sz = span_z / nz
    s = 0.4 * min(sy, sz)
    insts = []
    for j in range(ny):
        for k in range(nz):
            insts.append(
                {
                    "world_pos": [
                        35.2,
                        -span_y / 2 + (j + 0.5) * sy,
                        -span_z / 2 + (k + 0.5) * sz,
                    ],
                    "scale": [s, s, s],
                    "rotation_axis": [0.0, 0.0, 1.0],
                    "rotation_angle": (7 * j + 13 * k) % 90,
                }
            )
    prim["instances"] = insts
    os.makedirs(out_dir, exist_ok=True)
    src_dir = os.path.dirname(base)
    for aux in ("cube.obj", "s_01.png"):
        p = os.path.join(src_dir, aux)
        if os.path.exists(p):
            shutil.copy(p, out_dir)
    path = os.path.join(out_dir, "grid.json")
    json.dump(cfg, open(path, "w"))
    return path


def write_grid_fog_scene(
    out_dir,
    n=16,
    base=BASE_SCENE,
    max_depth=5,
    xres=None,
    yres=None,
    sigma_scale=1.0,
):
    """scene.json + an n^3 GridDensity camera medium (a smooth gaussian
    plume over the view volume x in [25,45]): BASELINE config 4's hard
    half (grid.rs delta/ratio tracking), exercised end-to-end.  Returns
    the json path.  The unit density box is placed with to_world alone
    (world_pos/scale) — the p0/p1 data2medium composition is broken in
    the reference (renderprocess.rs:1152-1156 reads key "p0" for both
    and composes it un-inverted), so portable scenes omit p0/p1."""
    cfg = json.load(open(base))
    if xres:
        cfg["Film"]["xres"] = xres
    if yres:
        cfg["Film"]["yres"] = yres
    cfg["Integrator"] = {
        "integrator_type": "Volpath", "max_depth": max_depth,
    }
    # smooth gaussian blob, peak 1.0 at the box center (few delta-
    # tracking steps near the edges, dense core around the cubes)
    zi, yi, xi = [
        (np.arange(n) + 0.5) / n - 0.5 for _ in range(3)
    ]
    r2 = (
        xi[None, None, :] ** 2 + yi[None, :, None] ** 2 + zi[:, None, None] ** 2
    )
    d = sigma_scale * np.exp(-r2 / 0.09)
    cfg.setdefault("Camera", {})["medium"] = {
        "medium_type": "GridDensity",
        "g": 0.0,
        "nx": n, "ny": n, "nz": n,
        "d": [round(float(v), 5) for v in d.ravel()],
        "world_pos": [25.0, -8.0, -6.0],
        "scale": [20.0, 16.0, 12.0],
    }
    os.makedirs(out_dir, exist_ok=True)
    src_dir = os.path.dirname(base)
    for aux in ("cube.obj",):
        p = os.path.join(src_dir, aux)
        if os.path.exists(p):
            shutil.copy(p, out_dir)
    path = os.path.join(out_dir, "grid_fog.json")
    json.dump(cfg, open(path, "w"))
    return path
