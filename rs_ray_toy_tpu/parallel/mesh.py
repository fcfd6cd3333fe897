"""Multi-chip rendering: the device mesh.

The reference's only parallelism is rayon tile-DP + a locked film merge
(integrator/mod.rs:64-65, film.rs:248; SURVEY §2.6).  Here it is data
parallelism over the pixel*sample batch on a flat 1-D 'dp' mesh (every
card reaches every other at the same rate, so the mesh follows the
algorithm alone): `render.render_job(mesh=...)` shard_maps each sample
pass over 'dp', so every device traces its slice of the pixel batch
against the replicated scene into a device-local film, and the films are
summed with a single `psum` — replacing merge_film_tile's RwLock with a
collective.
"""

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices=None, devices=None):
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devices), ("dp",))
