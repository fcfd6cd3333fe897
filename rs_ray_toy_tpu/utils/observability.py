"""Observability: counters, render stats, checkpoint/resume (SURVEY §5).

The reference's only metrics are an AtomicU64 ray counter
(integrator/mod.rs:63,101,137) and a colored-pixel count
(renderprocess.rs:1524-1528); errors are panics and the single fault-
tolerance feature is NaN/negative/infinite radiance scrubbing
(integrator/mod.rs:105-122 — implemented as scrub_radiance).

Here:
- RenderStats carries device-side counters (camera rays with weight>0,
  like the reference's counter; plus wall-clock and throughput);
- checkpointing: the film is a pure array pytree, so save/resume is a
  trivial npz round-trip (per SURVEY §5: film + sampler counters are the
  whole resumable state — samplers are counter-based so the next sample
  index is the only cursor);
- profiling: jax.profiler trace capture around the render when
  RS_PROFILE_DIR is set.
"""

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np
import jax


@dataclass
class RenderStats:
    camera_rays: int = 0
    elapsed_s: float = 0.0
    mrays_per_s: float = 0.0
    colored_pixels: int = 0
    extra: dict = field(default_factory=dict)

    def report(self):
        lines = [
            f"{self.camera_rays} rays generated",
            f"{self.elapsed_s:.3f}s render, {self.mrays_per_s:.3f} Mrays/s",
        ]
        if self.colored_pixels:
            lines.append(f"Colored Pixels: {self.colored_pixels}")
        return "\n".join(lines)


def save_checkpoint(path, film, next_sample_index, meta=None):
    """Film + sample cursor -> npz.  Everything needed to resume."""
    np.savez_compressed(
        path,
        xyz=np.asarray(film.xyz),
        weight=np.asarray(film.weight),
        splat_xyz=np.asarray(film.splat_xyz),
        next_sample_index=np.asarray(next_sample_index),
        **(meta or {}),
    )


def load_checkpoint(path):
    """-> (FilmState, next_sample_index)."""
    import jax.numpy as jnp

    from ..film.film import FilmState

    data = np.load(path)
    film = FilmState(
        xyz=jnp.asarray(data["xyz"]),
        weight=jnp.asarray(data["weight"]),
        splat_xyz=jnp.asarray(data["splat_xyz"]),
    )
    return film, int(data["next_sample_index"])


@contextlib.contextmanager
def maybe_profile():
    """Capture a jax.profiler trace when RS_PROFILE_DIR is set."""
    out = os.environ.get("RS_PROFILE_DIR", "")
    if not out:
        yield
        return
    with jax.profiler.trace(out):
        yield
