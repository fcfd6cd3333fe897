"""Sampler dimension discipline (sampler/dims.py rules).

Round-1 had two estimator-correlating collisions in the path integrator:
the BSSRDF block consumed get_1d and get_2d at the SAME slot (with the
stratified sampler both derive from one stratum permutation -> the light
pick and the light-surface sample were correlated), and its exit-direction
slot (old dim0+20) aliased bounce+2's Russian-roulette slot.  These tests
walk full max-depth paths with an auditing sampler and assert:

1. no slot is consumed by both get_1d and get_2d,
2. no slot is consumed twice by the same kind,
3. Halton maps slot d -> radical-inverse dims (2d, 2d+1) with get_1d
   using only 2d, so distinct slots are disjoint in the Halton sequence.
"""

import json
import os
import shutil
import tempfile

import numpy as np
import jax.numpy as jnp

from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler

from rs_ray_toy_tpu.scene.gen import SAMPLES_DIR as SAMPLES


class _AuditSampler(StratifiedSampler):
    def __init__(self, spec, seed=0):
        super().__init__(spec, seed)
        self.calls_1d = []
        self.calls_2d = []

    @staticmethod
    def _static(dim):
        return dim if isinstance(dim, int) else None

    def get_1d(self, pixel_id, sample_index, dim):
        self.calls_1d.append(self._static(dim))
        return super().get_1d(pixel_id, sample_index, dim)

    def get_2d(self, pixel_id, sample_index, dim):
        self.calls_2d.append(self._static(dim))
        return super().get_2d(pixel_id, sample_index, dim)

    def assert_disjoint(self):
        ones = [d for d in self.calls_1d if d is not None]
        twos = [d for d in self.calls_2d if d is not None]
        dup1 = {d for d in ones if ones.count(d) > 1}
        dup2 = {d for d in twos if twos.count(d) > 1}
        both = set(ones) & set(twos)
        assert not dup1, f"slots consumed twice by get_1d: {sorted(dup1)}"
        assert not dup2, f"slots consumed twice by get_2d: {sorted(dup2)}"
        assert not both, f"slots consumed by BOTH get_1d and get_2d: {sorted(both)}"


def _job(integrator="Path", max_depth=6):
    from rs_ray_toy_tpu.scene.loader import load_scene

    cfg = json.load(open(os.path.join(SAMPLES, "scene.json")))
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 8, 4
    cfg["Integrator"] = {"integrator_type": integrator, "max_depth": max_depth}
    td = tempfile.mkdtemp()
    shutil.copy(os.path.join(SAMPLES, "cube.obj"), td)
    path = os.path.join(td, "s.json")
    json.dump(cfg, open(path, "w"))
    return load_scene(path)


def _trace(li_fn, job, sampler, **kw):
    import jax
    from rs_ray_toy_tpu.integrators.common import SceneCtx

    ctx = kw.pop("ctx", None) or SceneCtx(job.scene)
    n = 8
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    w = jnp.ones((n,), jnp.float32)
    pid = jnp.arange(n, dtype=jnp.uint32)
    sid = jnp.zeros((n,), jnp.uint32)
    # trace (not run): records every sampler call site once
    jax.eval_shape(
        lambda o, d, w: li_fn(ctx, o, d, w, sampler, pid, sid, job.integrator, **kw),
        o, d, w,
    )
    return ctx


def test_path_dims_disjoint_with_bssrdf():
    from rs_ray_toy_tpu.integrators.common import SceneCtx
    from rs_ray_toy_tpu.integrators.path import li_path

    job = _job("Path", max_depth=6)
    ctx = SceneCtx(job.scene)
    # force the BSSRDF block on every material so its slots are audited
    ctx.mats = dict(ctx.mats)
    ctx.mats["has_bssrdf"] = jnp.ones_like(ctx.mats["has_bssrdf"])
    sampler = _AuditSampler(job.sampler)
    _trace(li_path, job, sampler, ctx=ctx)
    assert sampler.calls_1d and sampler.calls_2d
    sampler.assert_disjoint()


def test_volpath_dims_disjoint():
    from rs_ray_toy_tpu.integrators.volpath import li_volpath

    job = _job("VolPath", max_depth=6)
    sampler = _AuditSampler(job.sampler)
    _trace(li_volpath, job, sampler)
    sampler.assert_disjoint()


def test_halton_1d_2d_streams_disjoint():
    """Rule 3: slot d owns Halton dims (2d, 2d+1); get_1d reads 2d only."""
    from rs_ray_toy_tpu.core import lowdiscrepancy as ld
    from rs_ray_toy_tpu.sampler.halton import HaltonSampler
    from rs_ray_toy_tpu.scene.loader import SamplerSpec

    h = HaltonSampler(SamplerSpec(kind="halton", nsamp=16), 64, 64, seed=0)
    pid = jnp.arange(32, dtype=jnp.uint32)
    sid = jnp.ones((32,), jnp.uint32)
    for slot in (2, 3, 7):
        u1 = h.get_1d(pid, sid, slot)
        u2 = h.get_2d(pid, sid, slot)
        # the 1d stream is exactly the first component of the slot's pair
        np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2[:, 0]))
        # and two distinct slots never produce identical streams
        for other in (2, 3, 7):
            if other == slot:
                continue
            assert not np.array_equal(
                np.asarray(u1), np.asarray(h.get_1d(pid, sid, other))
            )
            assert not np.array_equal(
                np.asarray(u2[:, 1]), np.asarray(h.get_2d(pid, sid, other)[:, 1])
            )


def test_camera_rear_z_quirk():
    """camera.rs:575-578 computes `... / rear_z * rear_z` — left-to-right
    precedence cancels the two factors, so the non-simple weight is
    shutter_span * cos4 * A_pupil with NO rear_z^2 division.  Pin both
    weighting modes: their ratio must be exactly shutter_span * A0
    (the simple path divides by the bin-0 pupil area, nothing else)."""
    import dataclasses

    from rs_ray_toy_tpu.camera.realistic import RealisticCamera

    job = _job("Debug", max_depth=2)
    cam_s = RealisticCamera(job.camera, job.film, pupil_samples=1 << 10)
    spec_ns = dataclasses.replace(job.camera, simple_weighting=False)
    cam_ns = RealisticCamera(spec_ns, job.film, pupil_samples=1 << 10)

    n = 32
    pf = jnp.stack(
        [jnp.linspace(1.0, 7.0, n), jnp.linspace(0.5, 3.5, n)], axis=-1
    )
    u = jnp.stack([jnp.full((n,), 0.4), jnp.full((n,), 0.6)], axis=-1)
    _, _, w_s = cam_s.generate_rays(pf, u)
    _, _, w_ns = cam_ns.generate_rays(pf, u)
    live = np.asarray(w_s) > 0
    assert live.sum() > 4
    shutter_span = job.camera.shutter_close - job.camera.shutter_open
    area0 = cam_s._bin_area(0)
    np.testing.assert_allclose(
        np.asarray(w_ns)[live],
        np.asarray(w_s)[live] * area0 * shutter_span,
        rtol=1e-5,
    )


def test_permute_pow2_bijective_and_marginally_uniform():
    """rng.permute_pow2 must be (1) a permutation for every key and (2)
    near-uniform per fixed sample index across keys — consumers that do
    not exhaust all spp indices per pixel (single-sample probes, partial
    renders) otherwise inherit stratum bias (the pre-Kensler construction
    left several strata unreachable at fixed index)."""
    import jax.numpy as jnp
    import numpy as np
    from rs_ray_toy_tpu.core import rng

    for n in (2, 4, 16, 64, 1024):
        key = jnp.full((n,), 0xDEADBEEF, jnp.uint32)
        s = np.asarray(rng.permute_pow2(jnp.arange(n, dtype=jnp.uint32), n, key))
        assert sorted(s) == list(range(n)), n

    m = 200000
    pid = jnp.arange(m, dtype=jnp.uint32)
    key = rng.hash_combine(pid, jnp.uint32(123457))
    for i in (0, 3, 15):
        s = np.asarray(rng.permute_pow2(jnp.full((m,), i, jnp.uint32), 16, key))
        h = np.bincount(s, minlength=16)
        assert h.min() > 0.9 * m / 16 and h.max() < 1.1 * m / 16, (i, h)
