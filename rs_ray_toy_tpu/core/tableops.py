"""Row selection from small device tables.

Every per-ray lookup of a material, light or primitive attribute row goes
through `take_rows`, so the out-of-range policy is decided in one place:
indices outside [0, M) read as NaN for float tables (jnp.take's default
fill), never as a neighbouring row.  The reference has no analogue — its
scene access is pointer-chasing (primitive.rs, material/mod.rs dyn
dispatch).
"""

import jax.numpy as jnp


def take_rows(table, idx):
    """``table[idx]`` along the first axis: (M, ...) table, integer idx of
    any shape -> idx.shape + table.shape[1:]."""
    return jnp.take(table, idx, axis=0)


def take_axis1(v, idx):
    """Per-row selection along axis 1: ``v[n, idx[n]]``.

    v: (N, L, ...); idx: (N,) in [0, L)."""
    sel = jnp.take_along_axis(
        v, idx[(slice(None), None) + (None,) * (v.ndim - 2)], axis=1
    )
    return sel[:, 0]
