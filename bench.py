"""Benchmark: render each MATRIX row and report camera Mrays/s.

Every row runs in this one process, on the devices JAX finds, and prints
one JSON line naming the platform, device kind and device count it ran
on.  A row that fails prints its error as its line, the remaining rows
still run, and the process exits with code 1.  Nothing falls back to
another path or device.

    python bench.py                      # every row
    BENCH_CONFIGS=path,grid python bench.py
    BENCH_XRES=160 python bench.py       # smaller film for a quick check

RS_PROFILE_DIR=<dir> writes a profiler trace of each row's timed region
(tools/trace_top_ops.py reduces it to the top device operations).
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rs_ray_toy_tpu.scene.gen import (  # noqa: E402
    FOG_MEDIUM,
    write_base_scene,
    write_grid_fog_scene,
    write_grid_scene,
)

PUPIL_SAMPLES = 1 << 18

EXTRA_MATERIALS = {
    "mat_mirror": {
        "material_type": "MirrorMaterial", "material_name": "mat_mirror",
    },
    "mat_glass": {
        "material_type": "GlassMaterial",
        "material_name": "mat_glass",
        "eta": 1.5,
    },
    # Disney subsurface (probe-chain BSSRDF)
    "mat_sss": {
        "material_type": "DisneyMaterial",
        "material_name": "mat_sss",
        "color": {"values": [0.8, 0.6, 0.4]},
        "scatter_distance": {"values": [1.0, 0.8, 0.6]},
        "roughness": 0.3,
    },
    # textured matte: kd from the base scene's s_01.png image map
    "mat_textured": {
        "material_type": "MatteMaterial",
        "material_name": "mat_textured",
        "kd": "s_01",
    },
}

# (key, scene_kind, material, integrator, fog, spp, sppm_cfg)
MATRIX = [
    ("path", "ref", "", "path", False, 64, None),
    # low-discrepancy (Halton) sampler
    ("halton", "halton", "", "path", False, 256, None),
    ("debug", "ref", "", "debug", False, 16, None),
    ("sppm", "ref", "", "sppm", False, 0,
     {"radius": 1.0, "n_iters": 4, "max_depth": 3,
      "photons_per_iter": 1 << 17}),
    # 19,200-triangle instanced grid: BVH traversal
    ("grid", "grid", "", "path", False, 8, None),
    # homogeneous camera medium
    ("fog", "ref", "", "volpath", True, 16, None),
    # 16^3 GridDensity camera medium (delta/ratio tracking)
    ("grid_fog", "grid_fog", "", "volpath", False, 16, None),
    ("glass", "ref", "mat_glass", "path", False, 64, None),
    ("sss", "ref", "mat_sss", "path", False, 16, None),
    ("sphere_area", "sphere_area", "", "path", False, 64, None),
    ("fog_area", "fog_area", "", "volpath", True, 16, None),
    ("env", "env", "", "path", False, 64, None),
    ("textured", "ref", "mat_textured", "path", False, 16, None),
]


def _build_scene(work, scene_kind, material, integrator_kind, fog, spp,
                 sppm_cfg=None):
    """Materialize one benchmark scene under `work`; returns (path, tag)."""
    scene_path = write_base_scene(work)
    tag = "scene_json"
    if scene_kind == "grid":
        scene_path = write_grid_scene(work, ny=40, nz=40)
        tag = "grid19200tri"
    elif scene_kind == "grid_fog":
        scene_path = write_grid_fog_scene(work, n=16, sigma_scale=0.5)
        tag = "grid_fog16"

    with open(scene_path) as fh:
        cfg = json.load(fh)
    if scene_kind == "sphere_area":
        # sphere primitives + a sphere-area light (MIS NEE)
        cfg["Aggregate"]["primitives"].append({
            "primitive_type": "sphere", "material_name": "mat_matte",
            "radius": 1.2, "world_pos": [34.0, 0.8, 0.5]})
        cfg["Aggregate"]["primitives"].append({
            "primitive_type": "sphere", "material_name": "mat_matte",
            "radius": 0.8, "world_pos": [36.0, -1.2, -1.5]})
        cfg["lights"].append({
            "light_type": "diffuse",
            "spectrum": {"values": [30.0, 25.0, 20.0]},
            "light_shape": {"shape_type": "sphere", "radius": 0.5,
                            "world_pos": [33.0, 3.0, 1.0]}})
        tag += "_spharea"
    elif scene_kind == "fog_area":
        # sphere-area light MIS NEE in fog
        cfg["lights"].append({
            "light_type": "diffuse",
            "spectrum": {"values": [60.0, 50.0, 40.0]},
            "light_shape": {"shape_type": "sphere", "radius": 0.6,
                            "world_pos": [33.0, 3.0, 1.0]}})
        tag += "_spharea"
    elif scene_kind == "env":
        # constant environment light: NEE + BSDF branch + escape
        cfg["lights"] = [
            {"light_type": "infinite", "l": {"values": [1.0, 1.0, 1.0]}}
        ]
        cfg["infinite_lights"] = [
            {"light_type": "infinite", "l": {"values": [1.0, 1.0, 1.0]}}
        ]
        tag += "_env"
    if material:
        names = {m.get("material_name") for m in cfg["materials"]}
        if material in EXTRA_MATERIALS and material not in names:
            cfg["materials"].append(EXTRA_MATERIALS[material])
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = material
        tag += "_" + material.removeprefix("mat_")
    cfg_kind = {
        "path": "Path", "debug": "Debug", "direct": "DirectLighting",
        "volpath": "Volpath", "sppm": "SPPM",
    }[integrator_kind]
    cfg["Integrator"] = {**cfg.get("Integrator", {}), "integrator_type": cfg_kind}
    if cfg_kind == "SPPM":
        cfg["Integrator"].update(sppm_cfg or {})
    if fog:
        # homogeneous camera medium (VolPath)
        cfg["Camera"]["medium"] = dict(FOG_MEDIUM)
        tag += "_fog"
    if scene_kind == "halton":
        cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": spp}
        tag += "_halton"
    out = os.path.join(work, "bench.json")
    with open(out, "w") as fh:
        json.dump(cfg, fh)
    return out, tag


def _device_fields():
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def run_row(key, scene_kind, material, integrator_kind, fog, spp, sppm_cfg):
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.loader import load_scene

    with tempfile.TemporaryDirectory() as work:
        scene_path, tag = _build_scene(
            work, scene_kind, material, integrator_kind, fog, spp, sppm_cfg
        )
        job = load_scene(scene_path)
    if os.environ.get("BENCH_XRES"):
        job.film.xres = int(os.environ["BENCH_XRES"])
        job.film.yres = job.film.xres * 9 // 16
    t0 = time.time()
    res = render_job(job, spp_override=spp, pupil_samples=PUPIL_SAMPLES)
    wall = time.time() - t0
    sppm = integrator_kind == "sppm"
    value = res["camera_mrays_per_s"] if sppm else res["mrays_per_s"]
    line = {
        "config": key,
        "metric": f"camera_mrays_per_s_{tag}_{integrator_kind}",
        "value": float(value),
        "unit": "Mrays/s",
        "spp": res["camera_rays"] // (job.film.xres * job.film.yres),
        "film": [job.film.xres, job.film.yres],
        "render_s": float(res["elapsed_s"]),
        # set-up: scene tables, lens focus + exit pupil, compilation
        "setup_s": float(wall - res["elapsed_s"]),
        **_device_fields(),
    }
    if sppm:
        line["photon_mrays_per_s"] = float(res["photon_mrays_per_s"])
    return line


def main():
    from rs_ray_toy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    only = [s for s in os.environ.get("BENCH_CONFIGS", "").split(",") if s]
    unknown = set(only) - {row[0] for row in MATRIX}
    if unknown:
        raise SystemExit(f"unknown BENCH_CONFIGS: {sorted(unknown)}")
    failed = []
    for row in MATRIX:
        if only and row[0] not in only:
            continue
        try:
            line = run_row(*row)
        except Exception as e:  # report the row, keep the matrix going
            failed.append(row[0])
            line = {"config": row[0], "error": f"{type(e).__name__}: {e}",
                    **_device_fields()}
        print(json.dumps(line), flush=True)
    if failed:
        print(f"failed rows: {failed}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
