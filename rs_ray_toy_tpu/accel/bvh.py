"""BVH build (host) + flattened SoA layout for device traversal.

The reference builds an HLBVH (Morton + radix sort + LBVH treelets + top
SAH) with worker threads (bvh.rs:307-751) and flattens to a DFS
LinearBVHNode array.  Here the build is a host-side binned-SAH recursion
(numpy; 12 buckets like build_upper_sah) producing the same *flat layout*
the traversal needs:

    node i interior: left child = i+1 (DFS), right child = offset[i]
    node i leaf:     prims prim_offset[i] .. +n_prims[i]

which is exactly bvh.rs:103-109's LinearBVHNode contract.  Primitives are
reordered into leaf-contiguous order; a parallel (kind, index) table maps
back into the triangle/sphere SoA tables.  A C++ builder drop-in replaces
this for huge scenes (host build is O(T log T) python-recursion; fine to
~1e5 prims).

Traversal happens on device (traverse.py) over these arrays; scenes under
BRUTE_FORCE_CUTOFF skip the BVH entirely: for small prim counts a dense
all-pairs test needs no per-ray stack or data-dependent loop.
"""

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import DTYPE

N_BUCKETS = 12  # bvh.rs build_upper_sah bucket count
BRUTE_FORCE_CUTOFF = 256


@dataclass
class FlatBVH:
    bounds_min: jnp.ndarray  # (M,3)
    bounds_max: jnp.ndarray  # (M,3)
    offset: jnp.ndarray  # (M,) i32: interior -> right child; leaf -> prim start
    n_prims: jnp.ndarray  # (M,) i32: 0 for interior
    axis: jnp.ndarray  # (M,) i32 split axis
    prim_kind: jnp.ndarray  # (P,) i32 PRIM_TRI / PRIM_SPHERE
    prim_index: jnp.ndarray  # (P,) i32 row in the original SoA table
    max_leaf: int

    @property
    def n_nodes(self):
        return self.offset.shape[0]


def primitive_bounds(tri, sph):
    """World AABBs for every primitive: triangles then spheres."""
    parts_lo, parts_hi, kinds, index = [], [], [], []
    t = int(tri.count)
    if t:
        p = np.stack(
            [np.asarray(tri.p0), np.asarray(tri.p1), np.asarray(tri.p2)], axis=1
        )
        parts_lo.append(p.min(axis=1))
        parts_hi.append(p.max(axis=1))
        kinds.append(np.zeros(t, np.int32))
        index.append(np.arange(t, dtype=np.int32))
    s = int(sph.count)
    if s:
        o2w = np.asarray(sph.o2w)
        r = np.asarray(sph.radius)
        corners = np.array(
            [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64
        )
        pts = (
            np.einsum("sij,cj->sci", o2w[:, :3, :3], corners) * r[:, None, None]
            + o2w[:, None, :3, 3]
        )
        parts_lo.append(pts.min(axis=1))
        parts_hi.append(pts.max(axis=1))
        kinds.append(np.ones(s, np.int32))
        index.append(np.arange(s, dtype=np.int32))
    lo = np.concatenate(parts_lo) if parts_lo else np.zeros((0, 3))
    hi = np.concatenate(parts_hi) if parts_hi else np.zeros((0, 3))
    return (
        lo,
        hi,
        np.concatenate(kinds) if kinds else np.zeros(0, np.int32),
        np.concatenate(index) if index else np.zeros(0, np.int32),
    )


_NATIVE = None


def _native_lib():
    """Load the C++ builder (csrc/bvh_builder.cpp) via ctypes.

    The .so is not committed (unauditable, arch-specific): it is built
    on first use via the csrc Makefile; when the toolchain is missing we
    warn once and fall back to the python builder."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    import ctypes
    import os
    import subprocess
    import sys

    csrc = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "csrc"))
    so = os.path.join(csrc, "libbvh.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", csrc],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception as e:
            print(
                f"rs_ray_toy_tpu: native BVH builder unavailable ({e}); "
                "using the python builder",
                file=sys.stderr,
            )
            _NATIVE = False
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        print(
            f"rs_ray_toy_tpu: native BVH builder failed to load ({e}); "
            "using the python builder",
            file=sys.stderr,
        )
        _NATIVE = False
        return None
    c_dp = np.ctypeslib.ndpointer(np.float64, flags="C")
    c_fp = np.ctypeslib.ndpointer(np.float32, flags="C")
    c_ip = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.bvh_build_sah.argtypes = [
        c_dp, c_dp, np.ctypeslib.ctypes.c_int, np.ctypeslib.ctypes.c_int,
        c_fp, c_fp, c_ip, c_ip, c_ip, c_ip,
    ]
    lib.bvh_build_sah.restype = np.ctypeslib.ctypes.c_int
    _NATIVE = lib
    return lib


def _build_flat_native(lo, hi, max_prims_in_node):
    """Run the native SAH builder; returns flat arrays or None."""
    lib = _native_lib()
    if lib is None:
        return None
    n = lo.shape[0]
    cap = 2 * n
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    offset = np.zeros(cap, np.int32)
    nprims = np.zeros(cap, np.int32)
    axis = np.zeros(cap, np.int32)
    order = np.zeros(n, np.int32)
    m = lib.bvh_build_sah(
        np.ascontiguousarray(lo, np.float64),
        np.ascontiguousarray(hi, np.float64),
        n,
        max_prims_in_node,
        node_min,
        node_max,
        offset,
        nprims,
        axis,
        order,
    )
    if m <= 0:
        return None
    return node_min[:m], node_max[:m], offset[:m], nprims[:m], axis[:m], order


def build_bvh(tri, sph, max_prims_in_node=4) -> FlatBVH:
    lo, hi, kinds, index = primitive_bounds(tri, sph)
    if lo.shape[0] > 0:
        native = _build_flat_native(lo, hi, max_prims_in_node)
        if native is not None:
            nmin, nmax, offs, nprims, axes, order = native
            return FlatBVH(
                bounds_min=jnp.asarray(nmin),
                bounds_max=jnp.asarray(nmax),
                offset=jnp.asarray(offs),
                n_prims=jnp.asarray(nprims),
                axis=jnp.asarray(axes),
                prim_kind=jnp.asarray(kinds[order], jnp.int32),
                prim_index=jnp.asarray(index[order], jnp.int32),
                # bound by the leaves actually built, not the request —
                # traversal unrolls exactly max_leaf prim tests
                max_leaf=max(max_prims_in_node, int(nprims.max(initial=1))),
            )
    return build_bvh_py(tri, sph, max_prims_in_node)


def build_bvh_py(tri, sph, max_prims_in_node=4) -> FlatBVH:
    """Pure-python fallback builder (same layout)."""
    lo, hi, kinds, index = primitive_bounds(tri, sph)
    n = lo.shape[0]
    if n == 0:
        z3 = jnp.zeros((1, 3), DTYPE)
        zi = jnp.zeros((1,), jnp.int32)
        return FlatBVH(z3, z3, zi, zi, zi, zi[:0], zi[:0], max_prims_in_node)
    centroid = 0.5 * (lo + hi)

    nodes_min, nodes_max, offs, nprims, axes = [], [], [], [], []
    order = []  # permutation of prim ids into leaf order

    def emit(bmin, bmax, off, np_, ax):
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        offs.append(off)
        nprims.append(np_)
        axes.append(ax)
        return len(offs) - 1

    def surface_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def recurse(ids):
        bmin = lo[ids].min(axis=0)
        bmax = hi[ids].max(axis=0)
        if len(ids) <= max_prims_in_node:
            node = emit(bmin, bmax, len(order_flat), len(ids), 0)
            order_flat.extend(ids.tolist())
            return node
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        dim = int(np.argmax(cmax - cmin))
        if cmax[dim] - cmin[dim] < 1e-12:
            # coincident centroids: median-split until leaves fit
            # max_prims_in_node (the traversal loop is statically bounded
            # by max_leaf — an oversized leaf would silently drop prims)
            half = len(ids) // 2
            node = emit(bmin, bmax, -1, 0, dim)
            recurse(ids[:half])
            right_node = recurse(ids[half:])
            offs[node] = right_node
            return node
        # binned SAH along dim
        rel = (c[:, dim] - cmin[dim]) / (cmax[dim] - cmin[dim])
        b = np.minimum((rel * N_BUCKETS).astype(int), N_BUCKETS - 1)
        counts = np.bincount(b, minlength=N_BUCKETS)
        bucket_lo = np.full((N_BUCKETS, 3), np.inf)
        bucket_hi = np.full((N_BUCKETS, 3), -np.inf)
        for k in range(N_BUCKETS):
            m = b == k
            if m.any():
                bucket_lo[k] = lo[ids[m]].min(axis=0)
                bucket_hi[k] = hi[ids[m]].max(axis=0)
        best_cost, best_split = np.inf, -1
        total_sa = surface_area(bmin, bmax)
        for split in range(N_BUCKETS - 1):
            left = counts[: split + 1].sum()
            right = counts[split + 1 :].sum()
            if left == 0 or right == 0:
                continue
            sa_l = surface_area(
                bucket_lo[: split + 1].min(axis=0), bucket_hi[: split + 1].max(axis=0)
            )
            sa_r = surface_area(
                bucket_lo[split + 1 :].min(axis=0), bucket_hi[split + 1 :].max(axis=0)
            )
            cost = 0.125 + (left * sa_l + right * sa_r) / max(total_sa, 1e-20)
            if cost < best_cost:
                best_cost, best_split = cost, split
        if best_split < 0 or best_cost >= len(ids):
            # SAH says a leaf is cheaper (or no valid split): median split
            if len(ids) <= max_prims_in_node:
                node = emit(bmin, bmax, len(order_flat), len(ids), dim)
                order_flat.extend(ids.tolist())
                return node
            sel = np.argsort(c[:, dim])
            half = len(ids) // 2
            left_ids, right_ids = ids[sel[:half]], ids[sel[half:]]
        else:
            m = b <= best_split
            left_ids, right_ids = ids[m], ids[~m]
        node = emit(bmin, bmax, -1, 0, dim)
        recurse(left_ids)
        right_node = recurse(right_ids)
        offs[node] = right_node
        return node

    order_flat: list = []
    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * n + 100))
    try:
        recurse(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    order_arr = np.asarray(order_flat, np.int32)
    return FlatBVH(
        bounds_min=jnp.asarray(np.asarray(nodes_min), DTYPE),
        bounds_max=jnp.asarray(np.asarray(nodes_max), DTYPE),
        offset=jnp.asarray(offs, jnp.int32),
        n_prims=jnp.asarray(nprims, jnp.int32),
        axis=jnp.asarray(axes, jnp.int32),
        prim_kind=jnp.asarray(kinds[order_arr], jnp.int32),
        prim_index=jnp.asarray(index[order_arr], jnp.int32),
        max_leaf=max(max_prims_in_node, int(max(nprims, default=1))),
    )
