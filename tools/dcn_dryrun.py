"""Multi-host (DCN) dryrun: render through the PRODUCTION render_job
path on a 2-process jax.distributed CPU cluster and check the film
equals the single-process result.

The reference has no multi-host story at all (rayon is single-box);
ours is the same shard_map program — the 'dp' axis simply spans hosts,
XLA routes the film psum across processes, and render_job globalizes
its jit inputs when jax.process_count() > 1.

Usage:
  python tools/dcn_dryrun.py            # coordinator: spawns 2 workers
  python tools/dcn_dryrun.py --worker I # internal
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = int(os.environ.get("DCN_PORT", "52341"))
N_PROC = 2
DEV_PER_PROC = 4


def scene_path(td):
    import json

    from rs_ray_toy_tpu.scene.gen import write_base_scene

    cfg = json.load(open(write_base_scene(td)))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 3}
    p = os.path.join(td, "s.json")
    json.dump(cfg, open(p, "w"))
    return p


def _cpu_devices():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
    ).strip()
    import jax

    from rs_ray_toy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return jax


def run_worker(pid, td):
    jax = _cpu_devices()
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=N_PROC,
        process_id=pid,
    )
    assert jax.process_count() == N_PROC, jax.process_count()
    assert len(jax.devices()) == N_PROC * DEV_PER_PROC

    import numpy as np

    from rs_ray_toy_tpu.parallel.mesh import make_mesh
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.loader import load_scene

    p = os.path.join(td, "s.json")
    mesh = make_mesh()  # all 8 global devices, 'dp' spanning both hosts
    res = render_job(
        load_scene(p), spp_override=2, pupil_samples=1 << 10, seed=0, mesh=mesh
    )
    img = np.asarray(res["rgb_srgb_input"])
    if pid == 0:
        np.save(os.path.join(td, "dcn.npy"), img)
        # single-process reference on this worker's local 4 devices
        jax.distributed.shutdown()
    print(f"worker {pid} done img_sum={img.sum():.6f}", flush=True)


def main():
    if "--worker" in sys.argv:
        pid = int(sys.argv[sys.argv.index("--worker") + 1])
        run_worker(pid, sys.argv[sys.argv.index("--worker") + 2])
        return

    td = tempfile.mkdtemp()
    scene = scene_path(td)
    procs = []
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    for pid in range(N_PROC):
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(pid), td],
                env=env,
            )
        )
    rcs = [p.wait(timeout=1800) for p in procs]
    assert all(r == 0 for r in rcs), rcs

    # single-process reference (4 local devices) through the same path
    _cpu_devices()
    import numpy as np

    from rs_ray_toy_tpu.parallel.mesh import make_mesh
    from rs_ray_toy_tpu.render import render_job
    from rs_ray_toy_tpu.scene.loader import load_scene

    res = render_job(
        load_scene(scene), spp_override=2, pupil_samples=1 << 10, seed=0,
        mesh=make_mesh(),
    )
    single = np.asarray(res["rgb_srgb_input"])
    dcn = np.load(os.path.join(td, "dcn.npy"))
    diff = np.abs(single - dcn).max()
    print(f"multi-host vs single-process max|diff| = {diff:.3e}")
    assert diff < 1e-5, diff
    print("DCN dryrun OK: 2 hosts x 4 devices == 1 host x 4 devices")


if __name__ == "__main__":
    main()
