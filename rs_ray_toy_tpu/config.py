"""Global configuration for the renderer.

The reference (pppKin/rs_ray_toy) computes everything in f64 on CPU
(`geometry.rs:12-19`).  The device compute path is f32 throughout (f64 is
slow or absent on accelerators); host-side precomputation that is
numerically sensitive (lens focusing, BVH builds, CDF tables) runs in numpy
f64 and is then cast down.  Film accumulation uses f32 with per-pass
splitting, which is ample for 8-bit PNG output.
"""

import jax.numpy as jnp
import numpy as np

# Device dtype for all ray/shade math.
DTYPE = jnp.float32
# Host dtype for scene building / camera solves.
HOST_DTYPE = np.float64

INF = float("inf")
# f32 machine epsilon / 2, mirroring MACHINE_EPSILON in the reference
# (main.rs) but for the device dtype.
MACHINE_EPSILON = float(np.finfo(np.float32).eps) / 2.0
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
SHADOW_EPSILON = 1e-4  # misc.rs:18

PI = float(np.pi)
INV_PI = 1.0 / PI
INV_2_PI = 1.0 / (2.0 * PI)
INV_4_PI = 1.0 / (4.0 * PI)
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0

# Spectrum channel count.  The reference selects RGB (N=3) at compile time
# (main.rs:45-49); spectral N=60 is a config axis here as well.
SPECTRUM_N = 3


def gamma(n):
    """Error-propagation bound gamma(n) (misc.rs:40-41), device dtype."""
    return (n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON)
