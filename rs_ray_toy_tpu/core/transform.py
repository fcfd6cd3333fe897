"""4x4 affine transforms.

Host-side construction mirrors transform.rs (translate/scale/rotate/look_at,
transform.rs:254-429) in numpy f64; transforms are baked into world-space
scene arrays at load time, so the device path only ever sees a small table of
matrices (sphere prims keep theirs, everything else is pre-baked).

Device application helpers (`apply_point` etc.) take `(.., 4, 4)` matrices and
broadcast over ray batches as plain batched products at HIGHEST precision
(a default-precision float32 product may round its operands to TF32).
"""

import numpy as np
import jax.numpy as jnp

from .vec import normalize, cross


class Transform:
    """Immutable host transform with forward and inverse matrices."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        self.m = np.eye(4) if m is None else np.asarray(m, dtype=np.float64)
        if m_inv is None:
            m_inv = np.linalg.inv(self.m)
        self.m_inv = np.asarray(m_inv, dtype=np.float64)

    # ---- constructors (transform.rs:254-429) ----
    @staticmethod
    def translate(delta):
        d = np.asarray(delta, dtype=np.float64)
        m = np.eye(4)
        m[:3, 3] = d
        mi = np.eye(4)
        mi[:3, 3] = -d
        return Transform(m, mi)

    @staticmethod
    def scale(x, y, z):
        m = np.diag([x, y, z, 1.0])
        mi = np.diag([1.0 / x, 1.0 / y, 1.0 / z, 1.0])
        return Transform(m, mi)

    @staticmethod
    def rotate(theta_deg, axis):
        """Rotation about arbitrary axis, angle in degrees (transform.rs:327).

        The reference normalizes the axis and builds the matrix directly; an
        all-zero axis (scene files may omit it) normalizes to NaN in the
        reference only when the angle is nonzero — here a zero axis with zero
        angle yields identity, matching make_to_world's default behaviour.
        """
        a = np.asarray(axis, dtype=np.float64)
        n = np.linalg.norm(a)
        if n == 0.0:
            return Transform()
        a = a / n
        s = np.sin(np.deg2rad(theta_deg))
        c = np.cos(np.deg2rad(theta_deg))
        m = np.eye(4)
        m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
        m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
        m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
        m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
        m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
        m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
        m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
        m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
        m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
        return Transform(m, m.T)

    @staticmethod
    def look_at(pos, look, up):
        """Camera-to-world inverse pair (transform.rs:352-389).  Returns the
        world-to-camera transform like Transform::look_at (its .m is the
        inverse of camera_to_world)."""
        pos = np.asarray(pos, dtype=np.float64)
        look = np.asarray(look, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        dir_ = look - pos
        dir_ = dir_ / np.linalg.norm(dir_)
        upn = up / np.linalg.norm(up)
        left = np.cross(upn, dir_)
        ln = np.linalg.norm(left)
        if ln == 0.0:
            return Transform()
        left = left / ln
        new_up = np.cross(dir_, left)
        c2w = np.eye(4)
        c2w[:3, 0] = left
        c2w[:3, 1] = new_up
        c2w[:3, 2] = dir_
        c2w[:3, 3] = pos
        return Transform(np.linalg.inv(c2w), c2w)

    def inverse(self):
        return Transform(self.m_inv, self.m)

    def __mul__(self, other):
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def is_identity(self):
        return np.allclose(self.m, np.eye(4))

    # ---- host application (numpy, used during scene baking) ----
    def apply_point(self, p):
        p = np.asarray(p, dtype=np.float64)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        return r

    def apply_vector(self, v):
        v = np.asarray(v, dtype=np.float64)
        return v @ self.m[:3, :3].T

    def apply_normal(self, n):
        """Normals transform by the inverse transpose (transform.rs impl)."""
        n = np.asarray(n, dtype=np.float64)
        return n @ self.m_inv[:3, :3]


# ---- device application (jnp, batched) ----

def apply_point_jnp(m, p):
    """m: (...,4,4), p: (...,3) -> transformed points (batch dims
    broadcast)."""
    return apply_vector_jnp(m, p) + m[..., :3, 3]


def apply_vector_jnp(m, v):
    r = m[..., :3, :3]
    return jnp.einsum("...ij,...j->...i", r, v, precision="highest")


def apply_normal_jnp(m_inv, n):
    r = m_inv[..., :3, :3]
    return jnp.einsum("...ji,...j->...i", r, n, precision="highest")


def look_rotation(a):
    """Convenience for tests."""
    return normalize(cross(a, a))
