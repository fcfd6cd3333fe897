"""Smoke test on the GPU: the renderer's main path, checked for correctness.

    python chip_smoke.py               # phases 1-4 on one GPU
    python chip_smoke.py --devices 4   # the four-card phase only

Phases:
  1. device: the first JAX device must be a GPU; prints the card's name
     and power limit (nvidia-smi).
  2. estimator: the golden configurations (tests/golden/*.npy, rendered on
     the CPU) rendered on the card and compared with their goldens.
  3. traversal: BVH traversal against all-pairs intersection on 16,384
     camera rays into the 19,200-triangle grid scene.
  4. main path at full width: deploy_render of samples/scene.json
     (640x360, Debug) and render_job with Path at 64 spp.
  5. (--devices 4 only) render_job over a 4-device mesh against the same
     render on one device.

Each phase prints its wall time and the compilation time inside it.  Any
failure exits non-zero; the last line of a passing run is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
SAMPLES = os.path.join(ROOT, "samples")

# golden name -> (integrator config, seen through the fog medium, tolerance
# kind).  Debug and Direct are deterministic up to float rounding; Path and
# VolPath flip branches (Russian roulette, BSDF lobe picks) where float32
# operations run in another order, so they are held to a mean and a share
# of pixels.
GOLDENS = {
    "debug_40x24_2spp": (
        {"integrator_type": "Debug", "max_depth": 3}, False, "exact"),
    "direct_40x24_2spp": (
        {"integrator_type": "DirectLighting", "max_depth": 3,
         "light_strategy": "all"}, False, "exact"),
    "path_40x24_2spp": (
        {"integrator_type": "Path", "max_depth": 4}, False, "stochastic"),
    "volpath_fog_40x24_2spp": (
        {"integrator_type": "Volpath", "max_depth": 3}, True, "stochastic"),
}
EXACT_TOL, EXACT_SHARE = 1e-3, 0.99
STOCH_TOL, STOCH_SHARE, STOCH_MEAN = 1e-2, 0.97, 2e-3
# a pixel is lit where either image exceeds LIT in some channel; shares
# and means are taken over lit pixels only (at 40x24 the cubes cover a
# few dozen pixels, so a share of the whole film would let every lit
# pixel be wrong), and a golden with fewer than MIN_LIT lit pixels
# checks nothing and fails
LIT, MIN_LIT = 1e-4, 16


def image_diff(got, want, tol):
    """Per-pixel max-channel |got - want| over the lit pixels: the max,
    the mean, the share of lit pixels over tol, and how many pixels the
    golden lights."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != golden {want.shape}")
    d = np.abs(got - want)
    lit = (want.max(axis=-1) > LIT) | (got.max(axis=-1) > LIT)
    per_px = d.max(axis=-1)[lit]
    return {
        "golden_lit": int((want.max(axis=-1) > LIT).sum()),
        "lit": int(lit.sum()),
        "max": float(d.max()),
        "mean": float(d[lit].mean()) if lit.any() else 0.0,
        "share_over": float((per_px > tol).mean()) if lit.any() else 0.0,
    }


def golden_ok(stats, kind):
    """True if a golden comparison passes its tolerance kind."""
    if stats["golden_lit"] < MIN_LIT:
        return False
    if kind == "exact":
        return stats["share_over"] <= 1.0 - EXACT_SHARE
    return (
        stats["mean"] <= STOCH_MEAN and stats["share_over"] <= 1.0 - STOCH_SHARE
    )


def hits_agree(t_a, idx_a, hit_a, t_b, idx_b, hit_b, rtol=1e-5):
    """Compare two closest-hit results.  Returns (stats, ok): hit/miss
    agree on >= 99.99% of rays; where both hit, t agrees to rtol; the
    primitive matches unless both candidates lie at the same t (a tie,
    e.g. a ray through the shared edge of two triangles)."""
    t_a, t_b = np.asarray(t_a, np.float64), np.asarray(t_b, np.float64)
    hit_a, hit_b = np.asarray(hit_a, bool), np.asarray(hit_b, bool)
    both = hit_a & hit_b
    t_a, t_b = np.where(both, t_a, 1.0), np.where(both, t_b, 1.0)
    rel = np.abs(t_a - t_b) / np.maximum(np.abs(t_b), 1e-30)
    t_bad = both & (rel > rtol)
    prim_bad = both & (np.asarray(idx_a) != np.asarray(idx_b)) & (rel > rtol)
    miss_share = float((hit_a != hit_b).mean())
    stats = {
        "rays": int(hit_a.size),
        "both_hit": int(both.sum()),
        "hit_mismatch_share": miss_share,
        "t_max_rel": float(rel[both].max()) if both.any() else 0.0,
        "t_over_tol": int(t_bad.sum()),
        "prim_mismatch_not_tie": int(prim_bad.sum()),
    }
    ok = miss_share <= 1e-4 and not t_bad.any() and not prim_bad.any()
    return stats, ok


def films_agree(a, b, rtol=1e-5, atol=1e-7):
    """Film comparison for the mesh phase, value by value:
    |a - b| <= atol + rtol * |a|.  Also reports the largest relative gap,
    the largest gap in float32 units in the last place, and whether the
    films are bit-equal."""
    a32 = np.asarray(a, np.float32)
    b32 = np.asarray(b, np.float32)
    a, b = a32.astype(np.float64), b32.astype(np.float64)
    d = np.abs(a - b)
    rel = d / np.maximum(np.abs(a), atol / rtol)
    # ulp distance: the int32 views of two same-signed floats differ by
    # the number of representable values between them
    same = np.signbit(a32) == np.signbit(b32)
    ulp = np.abs(a32.view(np.int32).astype(np.int64)
                 - b32.view(np.int32).astype(np.int64))
    info = {
        "max_abs_diff": float(d.max()),
        "max_rel_diff": float(rel.max()),
        "max_ulp": int(ulp[same].max()) if same.any() else 0,
        "values_differing": int((d > 0).sum()),
        "bit_equal": bool(np.array_equal(a32, b32)),
    }
    return info, bool(np.all(d <= atol + rtol * np.abs(a)))


class _Compiles:
    """Sums JAX's compile-stage durations (trace, lowering, backend)."""

    def __init__(self):
        self.total = 0.0
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.total += secs


def _phase(name, compiles, fn):
    t0, c0 = time.time(), compiles.total
    info = fn()
    print(json.dumps({
        "phase": name,
        "wall_s": round(time.time() - t0, 3),
        "compile_s": round(compiles.total - c0, 3),
        **info,
    }), flush=True)
    return info


def _scene_variant(work, integrator, medium=None, xres=None, yres=None):
    from rs_ray_toy_tpu.scene.gen import BASE_SCENE

    with open(BASE_SCENE) as fh:
        cfg = json.load(fh)
    if xres:
        cfg["Film"]["xres"], cfg["Film"]["yres"] = xres, yres
    cfg["Integrator"] = integrator
    if medium is not None:
        cfg["Camera"]["medium"] = medium
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), work)
    path = os.path.join(work, "variant.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (first device is {dev.platform})"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def phase_estimator():
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.gen import FOG_MEDIUM
    from rs_ray_toy_tpu.scene.loader import load_scene

    results, failed = {}, []
    for name, (integ, fog, kind) in GOLDENS.items():
        want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
        medium = dict(FOG_MEDIUM) if fog else None
        with tempfile.TemporaryDirectory() as work:
            job = load_scene(_scene_variant(work, integ, medium, 40, 24))
        got = np.asarray(render_job(
            job, spp_override=2, pupil_samples=1 << 10, seed=0
        )["rgb_srgb_input"])
        tol = EXACT_TOL if kind == "exact" else STOCH_TOL
        stats = image_diff(got, want, tol)
        results[name] = stats
        if not golden_ok(stats, kind):
            failed.append(name)
    if failed:
        raise SystemExit(f"estimator phase failed: {failed} {results}")
    return {"goldens": results}


def phase_traversal():
    import jax
    import jax.numpy as jnp

    from rs_ray_toy_tpu.accel import geometry as geom
    from rs_ray_toy_tpu.accel.traverse import intersect_bvh
    from rs_ray_toy_tpu.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu.integrators.common import SceneCtx
    from rs_ray_toy_tpu.scene.gen import write_grid_scene
    from rs_ray_toy_tpu.scene.loader import load_scene

    with tempfile.TemporaryDirectory() as work:
        job = load_scene(write_grid_scene(work, ny=40, nz=40))
    ctx = SceneCtx(job.scene)
    if ctx.bvh is None:
        raise SystemExit("traversal phase: the grid scene built no BVH")
    cam = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16)
    # 16,384 camera rays that leave the lens (vignetted candidates have
    # zero weight and no meaningful direction), aimed at the middle of
    # the film where the grid of cubes is
    n, n_cand = 16384, 65536
    rng = np.random.default_rng(0)
    p_film = (0.3 + 0.4 * rng.random((n_cand, 2))) * [
        job.film.xres, job.film.yres
    ]
    o, d, w = cam.generate_rays(
        jnp.asarray(p_film, jnp.float32),
        jnp.asarray(rng.random((n_cand, 2)), jnp.float32),
    )
    live = np.flatnonzero(np.asarray(w) > 0.0)[:n]
    if live.size < n:
        raise SystemExit(f"traversal phase: only {live.size} live rays")
    o, d = o[live], d[live]
    t_max = jnp.full((n,), jnp.inf, jnp.float32)

    bvh_fn = jax.jit(
        lambda o, d, t: intersect_bvh(ctx.bvh, ctx.tri, ctx.sph, o, d, t)
    )
    brute_fn = jax.jit(
        lambda o, d, t: geom.intersect_brute(ctx.tri, ctx.sph, o, d, t)
    )
    hb = bvh_fn(o, d, t_max)
    chunk = 1024
    parts = [
        brute_fn(o[i:i + chunk], d[i:i + chunk], t_max[i:i + chunk])
        for i in range(0, n, chunk)
    ]
    cat = lambda f: np.concatenate([np.asarray(getattr(h, f)) for h in parts])
    stats, ok = hits_agree(
        hb.t, hb.index, hb.valid, cat("t"), cat("index"), cat("valid")
    )
    stats["triangles"] = int(ctx.tri.count)
    if not ok:
        raise SystemExit(f"traversal phase failed: {stats}")
    return stats


def phase_main_path():
    from rs_ray_toy_tpu.render import deploy_render, render_job
    from rs_ray_toy_tpu.scene.loader import load_scene

    scene = os.path.join(SAMPLES, "scene.json")
    out = {}
    with tempfile.TemporaryDirectory() as work:
        res = deploy_render(scene, os.path.join(work, "out.png"))
    out["debug"] = _render_facts(res)
    job = load_scene(scene)
    job.integrator.kind = "path"
    res = render_job(job, spp_override=64)
    out["path_64spp"] = _render_facts(res)
    return out


def _render_facts(res):
    rgb = np.asarray(res["rgb_srgb_input"])
    colored = int((rgb.sum(axis=-1) > 0).sum())
    if not np.isfinite(rgb).all() or colored == 0:
        raise SystemExit(
            f"main path: finite={bool(np.isfinite(rgb).all())} "
            f"colored={colored}"
        )
    return {
        "film": list(rgb.shape[:2]),
        "colored_pixels": colored,
        "elapsed_s": float(res["elapsed_s"]),
        "mrays_per_s": float(res["mrays_per_s"]),
    }


def phase_mesh(n_devices):
    import jax

    from rs_ray_toy_tpu.parallel.mesh import make_mesh
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.loader import load_scene

    if jax.device_count() < n_devices:
        raise SystemExit(
            f"mesh phase: need {n_devices} devices, have {jax.device_count()}"
        )
    scene = os.path.join(SAMPLES, "scene.json")
    films = {}
    for label, mesh in (("one", None), ("mesh", make_mesh(n_devices))):
        job = load_scene(scene)
        job.integrator.kind = "path"
        res = render_job(job, spp_override=64, mesh=mesh)
        films[label] = res["film"]
        films[label + "_rate"] = float(res["mrays_per_s"])
    # the base scene's box filter puts every sample on its own pixel, so
    # the weights must be bit-equal; the radiance is held to a relative
    # 1e-5 per value, not to bit equality, because each device compiles
    # its quarter of the batch with other fused multiply-adds (a few ulps)
    xyz, ok_xyz = films_agree(films["one"].xyz, films["mesh"].xyz)
    weight_equal = bool(np.array_equal(
        np.asarray(films["one"].weight), np.asarray(films["mesh"].weight)
    ))
    info = {
        "devices": n_devices,
        "xyz": xyz,
        "weight_bit_equal": weight_equal,
        "mrays_per_s_one": films["one_rate"],
        "mrays_per_s_mesh": films["mesh_rate"],
    }
    if not (ok_xyz and weight_equal):
        raise SystemExit(f"mesh phase failed: {info}")
    return info


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the mesh phase on this many devices")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    from rs_ray_toy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    compiles = _Compiles()
    device = _phase("device", compiles, phase_device)
    if args.devices > 1:
        _phase("mesh", compiles, lambda: phase_mesh(args.devices))
    else:
        _phase("estimator", compiles, phase_estimator)
        _phase("traversal", compiles, phase_traversal)
        _phase("main_path", compiles, phase_main_path)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"],
        "kind": device["kind"],
        "count": device["count"],
    }}))


if __name__ == "__main__":
    main()
