"""Scene data model: frozen SoA pytrees.

The reference's object graph (Arc<dyn Primitive>/Material/Light,
primitives.rs:14-39, scene.rs:13-19) becomes flat device tables:

- triangles are instance-expanded and baked to world space (affine transforms
  commute with Möller-Trumbore, so TransformedPrimitive semantics
  (primitives.rs:115-140) are preserved exactly for meshes);
- spheres keep their object->world transforms in a matrix table because
  partial-sphere clipping (z_min/z_max/phi_max) happens in object space
  (shape/sphere.rs);
- materials are rows into a lobe table (see bsdf/lobes.py);
- lights are a typed SoA table.

Every table is a frozen dataclass registered as a pytree, so jit and
shard_map can carry it.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..config import DTYPE


def _table(cls):
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


# light type codes
LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_DIFFUSE_AREA = 2
LIGHT_INFINITE = 3

# area-light shape codes (diffuse lights sample a shape: sphere or one
# triangle, renderprocess.rs:999-1017)
AREA_SHAPE_NONE = -1
AREA_SHAPE_SPHERE = 0
AREA_SHAPE_TRIANGLE = 1


@_table
class TriangleSoA:
    p0: jnp.ndarray  # (T,3)
    p1: jnp.ndarray
    p2: jnp.ndarray
    n0: jnp.ndarray  # shading normals, zeros when has_n is False
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # (T,2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    has_n: jnp.ndarray  # (T,) bool
    mat: jnp.ndarray  # (T,) int32 material ids
    area_light: jnp.ndarray  # (T,) int32 light id or -1
    med_in: jnp.ndarray  # (T,) int32 medium id inside or -1
    med_out: jnp.ndarray  # (T,) int32 medium id outside or -1
    # precomputed ray-independent shading geometry (host f64 -> f32):
    # geometric normal and uv-parameterization partials
    # (triangle.rs:276-299 computes these per hit; they only depend on the
    # triangle, so we bake them at load)
    ng: jnp.ndarray  # (T,3)
    dpdu: jnp.ndarray  # (T,3)
    dpdv: jnp.ndarray  # (T,3)

    @property
    def count(self):
        return self.p0.shape[0]


@_table
class SphereSoA:
    o2w: jnp.ndarray  # (S,4,4)
    w2o: jnp.ndarray  # (S,4,4)
    radius: jnp.ndarray  # (S,)
    z_min: jnp.ndarray
    z_max: jnp.ndarray
    theta_min: jnp.ndarray
    theta_max: jnp.ndarray
    phi_max: jnp.ndarray  # radians
    mat: jnp.ndarray  # (S,) int32
    area_light: jnp.ndarray  # (S,) int32 light id or -1
    med_in: jnp.ndarray  # (S,) int32 medium id inside or -1
    med_out: jnp.ndarray  # (S,) int32 medium id outside or -1

    @property
    def count(self):
        return self.radius.shape[0]


@_table
class LightSoA:
    kind: jnp.ndarray  # (L,) int32 LIGHT_*
    # point: world position; distant: (unused); diffuse: shape ref
    p: jnp.ndarray  # (L,3)
    # point: intensity I; distant/diffuse/infinite: radiance L(*scale)
    emit: jnp.ndarray  # (L,3)
    w_light: jnp.ndarray  # (L,3) distant light direction (normalized)
    # world bounding sphere (distant lights need scene radius,
    # lights/distant.rs:23-60)
    world_center: jnp.ndarray  # (3,)
    world_radius: jnp.ndarray  # ()
    # diffuse area lights: which shape
    shape_kind: jnp.ndarray  # (L,) int32 AREA_SHAPE_*
    shape_index: jnp.ndarray  # (L,) int32 row in sphere/triangle table
    n_samples: jnp.ndarray  # (L,) int32
    two_sided: jnp.ndarray  # (L,) bool (reference DiffuseAreaLight is 1-sided)
    # area-light shape payload (diffuse lights own their shape,
    # lights/diffuse.rs; it is NOT part of the aggregate)
    sph_o2w: jnp.ndarray  # (L,4,4)
    sph_w2o: jnp.ndarray  # (L,4,4)
    sph_radius: jnp.ndarray  # (L,)
    tri_p: jnp.ndarray  # (L,3,3) triangle vertices (world)
    area: jnp.ndarray  # (L,) shape surface area

    @property
    def count(self):
        return self.kind.shape[0]


def empty_triangles():
    z3 = jnp.zeros((0, 3), DTYPE)
    z2 = jnp.zeros((0, 2), DTYPE)
    zi = jnp.zeros((0,), jnp.int32)
    zb = jnp.zeros((0,), bool)
    return TriangleSoA(z3, z3, z3, z3, z3, z3, z2, z2, z2, zb, zi, zi, zi, zi, z3, z3, z3)


def empty_spheres():
    z = jnp.zeros((0,), DTYPE)
    zi = jnp.zeros((0,), jnp.int32)
    m = jnp.zeros((0, 4, 4), DTYPE)
    return SphereSoA(m, m, z, z, z, z, z, z, zi, zi, zi, zi)
