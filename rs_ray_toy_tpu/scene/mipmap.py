"""MIPMap: host pyramid build + device trilinear / EWA lookups.

The reference stores each level in a cache-blocked BlockedArray
(memory.rs:24-98, mipmap.rs:73-131); on the device plain dense levels
are right — XLA picks layouts — so the pyramid is a list of (H,W,3)
arrays, padded to power-of-two via Lanczos-equivalent resampling
(mipmap.rs:270+ uses Lanczos; we use separable box/linear resampling on
host, noted divergence: affects only non-pow2 source images'
minification tail).

`trilinear_lookup` gathers 8 texels (mipmap.rs:132-149) and `ewa_lookup`
filters an elliptical window (mipmap.rs:150-189); environment maps use
the former.  Image textures read the packed coarse pyramid instead
(`MIPMap.as_packed`, `packed_*_lookup`), with the gather lookups as its
exact reference.
"""

from dataclasses import dataclass
from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import DTYPE
from ..core.tableops import take_rows

WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2

# per-level border texels baked into the packed pyramid (>= the EWA
# window, covers bilerp's +/-1 too) so one contiguous window per ray is
# always a valid fetch
_BORDER = 16


@dataclass
class MIPMap:
    levels: List[np.ndarray]  # finest first, each (H,W,3) float32
    wrap: int
    do_trilinear: bool
    max_aniso: float

    @property
    def width(self):
        return self.levels[0].shape[1]

    @property
    def height(self):
        return self.levels[0].shape[0]

    def as_device(self):
        """Pack pyramid into one padded (L, Hmax+2B, Wmax+2B, C) array.

        Each level carries a B-texel wrap-mode border (REPEAT copies the
        opposite edge, CLAMP replicates the edge, BLACK stays zero), so
        device lookups fetch one contiguous window per ray with a single
        vmapped dynamic_slice, instead of one gather per texel (the EWA
        window scan would do 512 of them per level pair)."""
        hmax = self.levels[0].shape[0]
        wmax = self.levels[0].shape[1]
        n = len(self.levels)
        c = self.levels[0].shape[2]
        B = _BORDER
        # channel-FOLDED (L, Hp, Wp*C): texel (t,s) occupies columns
        # [s*C, (s+1)*C), so a per-ray window is one contiguous
        # (1, wh, ww*C) slice whose tiled layout pads only the folded
        # minor axis (a window tensor with a bare 3-wide channel dim
        # gets that dim padded to 128 — a 42x blowup that OOM'd at
        # 230K rays)
        packed = np.zeros(
            (n, hmax + 2 * B, (wmax + 2 * B) * c), np.float32
        )
        dims = np.zeros((n, 2), np.int32)
        for i, lv in enumerate(self.levels):
            h, w = lv.shape[:2]
            dims[i] = (h, w)
            if self.wrap == WRAP_BLACK:
                packed[i, B : B + h, B * c : (B + w) * c] = lv.reshape(
                    h, w * c
                )
                continue
            yi = np.arange(-B, h + B)
            xi = np.arange(-B, w + B)
            if self.wrap == WRAP_REPEAT:
                yi, xi = yi % h, xi % w
            else:  # WRAP_CLAMP
                yi = np.clip(yi, 0, h - 1)
                xi = np.clip(xi, 0, w - 1)
            bordered = lv[yi[:, None], xi[None, :]]  # (h+2B, w+2B, c)
            packed[i, : h + 2 * B, : (w + 2 * B) * c] = bordered.reshape(
                h + 2 * B, (w + 2 * B) * c
            )
        return {
            "data": jnp.asarray(packed),
            "dims": jnp.asarray(dims),
            "wrap": self.wrap,
            "n_levels": n,
            "channels": c,
        }


    def as_packed(self):
        """Pack the COARSE pyramid (every level with H <= 64) into one
        (128, Wmax*C) table for gather-free matmul lookups.

        A bilerp at level l is a 2-hot row-weight vector (rows t0/t1 of
        level l's row block, weights 1-dt/dt) times the packed table —
        one (N,128)@(128,Wc) matmul — followed by an iota-compare column
        extract for the s0/s1 lerp.  It replaces per-ray texel gathers:
        on an H100 the textured bench row renders about 29 camera Mrays/s
        through it against about 7.2 through `ewa_lookup`'s window
        gathers, so it is the only lookup image textures use, and the
        gather lookups remain as its exact reference.

        Lookups at levels FINER than lod_min are clamped to lod_min
        (documented divergence: close-up texture detail blurs to the
        64-row level; exact for every lookup landing at lod >= lod_min,
        which covers typical minified primary hits).  Images that are
        already <= 64 rows pack their whole pyramid: lod_min == 0, the
        packed path is exact everywhere.
        """
        heights = [lv.shape[0] for lv in self.levels]
        lod_min = 0
        while sum(heights[lod_min:]) > 128 or heights[lod_min] > 64:
            lod_min += 1
        c = self.levels[0].shape[2]
        wmax = self.levels[lod_min].shape[1]
        rows = sum(heights[lod_min:])
        # channel-PLANAR columns: col = c*wmax + s.  The s-lerp extraction
        # then reads each channel as a static (N, wmax) slice and reduces
        # over lanes — no second matmul
        table = np.zeros((128, wmax * c), np.float32)
        # per-level (h, w, row_offset) as STATIC python ints: level meta
        # rides select chains, never a per-ray table lookup.  Finer-than-
        # packed levels alias lod_min's meta (lookups clamp before use).
        meta = [None] * len(self.levels)
        off = 0
        for l, lv in enumerate(self.levels):
            if l < lod_min:
                continue
            h, w = lv.shape[:2]
            meta[l] = (h, w, off)
            for ch in range(c):
                table[off : off + h, ch * wmax : ch * wmax + w] = lv[..., ch]
            off += h
        for l in range(lod_min):
            meta[l] = meta[lod_min]
        assert off == rows <= 128
        return {
            "table": jnp.asarray(table),
            "meta": tuple(meta),
            "lod_min": lod_min,
            "wrap": self.wrap,
            "n_levels": len(self.levels),
            "channels": c,
            "wmax": wmax,
        }


def _next_pow2(x):
    return 1 << (int(x) - 1).bit_length()


def _resample_axis(img, new_n, axis):
    """Separable linear resample to new_n along axis (host)."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    pos = (np.arange(new_n) + 0.5) * old_n / new_n - 0.5
    lo = np.clip(np.floor(pos).astype(int), 0, old_n - 1)
    hi = np.clip(lo + 1, 0, old_n - 1)
    t = (pos - lo).reshape([-1 if i == axis else 1 for i in range(img.ndim)])
    a = np.take(img, lo, axis=axis)
    b = np.take(img, hi, axis=axis)
    return a * (1 - t) + b * t


def build_mipmap(image, wrap=WRAP_REPEAT, do_trilinear=False, max_aniso=8.0):
    """image: (H,W,3) float in linear space, bottom row = v=0 (the loader
    flips PNG rows like renderprocess.rs:555-561)."""
    img = np.asarray(image, np.float64)
    h, w = img.shape[:2]
    ph, pw = _next_pow2(h), _next_pow2(w)
    if (ph, pw) != (h, w):
        img = _resample_axis(_resample_axis(img, pw, 1), ph, 0)
    levels = [img.astype(np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        prev = levels[-1].astype(np.float64)
        nh = max(1, prev.shape[0] // 2)
        nw = max(1, prev.shape[1] // 2)
        if prev.shape[0] > 1 and prev.shape[1] > 1:
            down = 0.25 * (
                prev[0::2, 0::2] + prev[1::2, 0::2] + prev[0::2, 1::2] + prev[1::2, 1::2]
            )
        elif prev.shape[0] > 1:
            down = 0.5 * (prev[0::2] + prev[1::2])
        else:
            down = 0.5 * (prev[:, 0::2] + prev[:, 1::2])
        levels.append(down.astype(np.float32))
    return MIPMap(levels, wrap, do_trilinear, max_aniso)


def _st_norm(st, wrap):
    """Wrap-normalize continuous st so window starts stay inside the
    padded borders.  REPEAT: taking the fraction shifts every texel
    index by an exact multiple of the level size (mod-invariant).
    CLAMP: clipping st reproduces per-index clamping via the
    edge-replicated border.  BLACK: bounded clip only (the logical
    inside-mask zeroes out-of-image texels exactly)."""
    if wrap == WRAP_REPEAT:
        return st - jnp.floor(st)
    if wrap == WRAP_CLAMP:
        return jnp.clip(st, 0.0, 1.0 - 1e-7)
    return jnp.clip(st, -1.5, 2.5)


# rays per lax.map chunk in _window: bounds the gather output's live
# footprint ((CHUNK, wh, ww*C) padded to 128 lanes — 268 MB at the EWA
# window) instead of materializing the whole batch's windows at once
_WINDOW_CHUNK = 1 << 15


def _window(dev, level, t0, s0, wh, ww):
    """Fetch each ray's texel window with chunked vmapped dynamic_slices
    (each lowers to a single gather with slice_sizes) — the per-texel
    form serialized as ~25-30 ms gathers per 230K rays on the bench
    chip; the EWA scan issued 512 of them per level pair.  Returns
    (C, wh, ww, N): rays on the MINOR axis so downstream tiled layouts
    pad only the 128-lane dim."""
    data = dev["data"]  # (L, Hp, Wp*C) channel-folded
    c = dev["channels"]
    n = level.shape[0]

    def one(lvl, t, s):
        return lax.dynamic_slice(
            data, (lvl, t + _BORDER, (s + _BORDER) * c), (1, wh, ww * c)
        )[0]

    def chunk_fn(args):
        lvl, t, s = args
        w = jax.vmap(one)(lvl, t, s)  # (CH, wh, ww*c)
        return jnp.moveaxis(w, 0, -1)  # (wh, ww*c, CH)

    lvl = level.astype(jnp.int32)
    tt = t0.astype(jnp.int32)
    ss = s0.astype(jnp.int32)
    if n > _WINDOW_CHUNK:
        pad = (-n) % _WINDOW_CHUNK
        if pad:
            z = jnp.zeros((pad,), jnp.int32)
            lvl = jnp.concatenate([lvl, z])
            tt = jnp.concatenate([tt, z])
            ss = jnp.concatenate([ss, z])
        nc = lvl.shape[0] // _WINDOW_CHUNK
        out = lax.map(
            chunk_fn,
            (
                lvl.reshape(nc, _WINDOW_CHUNK),
                tt.reshape(nc, _WINDOW_CHUNK),
                ss.reshape(nc, _WINDOW_CHUNK),
            ),
        )  # (nc, wh, ww*c, CH)
        win = jnp.moveaxis(out, 0, 2).reshape(wh, ww * c, nc * _WINDOW_CHUNK)
        win = win[..., :n]
    else:
        win = chunk_fn((lvl, tt, ss))  # (wh, ww*c, n)
    # unfold channels: (wh, ww, c, N) -> (c, wh, ww, N)
    return jnp.moveaxis(win.reshape(wh, ww, c, n), 2, 0)


def _black_mask(s0, t0, w, h, n):
    """(n, n, N) logical inside-mask for WRAP_BLACK windows."""
    di = jnp.arange(n, dtype=jnp.int32)
    si = s0[None, :] + di[:, None]  # (n, N)
    ti = t0[None, :] + di[:, None]
    s_ok = (si >= 0) & (si < w.astype(jnp.int32)[None, :])
    t_ok = (ti >= 0) & (ti < h.astype(jnp.int32)[None, :])
    return t_ok[:, None, :] & s_ok[None, :, :]


def _bilerp_level(dev, level, st):
    """Bilinear at continuous st on a given (per-ray) level."""
    dims = take_rows(dev["dims"], level)
    h = dims[..., 0].astype(DTYPE)
    w = dims[..., 1].astype(DTYPE)
    wrap = dev["wrap"]
    stn = _st_norm(st, wrap)
    s = stn[..., 0] * w - 0.5
    t = stn[..., 1] * h - 0.5
    s0 = jnp.floor(s).astype(jnp.int32)
    t0 = jnp.floor(t).astype(jnp.int32)
    ds = s - s0.astype(DTYPE)  # (N,)
    dt = t - t0.astype(DTYPE)
    win = _window(dev, level, t0, s0, 2, 2)  # (C, 2, 2, N): [t, s]
    if wrap == WRAP_BLACK:
        win = win * _black_mask(s0, t0, w, h, 2)[None]
    v00 = win[:, 0, 0]  # (C, N)
    v10 = win[:, 0, 1]
    v01 = win[:, 1, 0]
    v11 = win[:, 1, 1]
    out = (
        (1 - ds) * (1 - dt) * v00
        + ds * (1 - dt) * v10
        + (1 - ds) * dt * v01
        + ds * dt * v11
    )
    return out.T  # (N, C)


def trilinear_lookup(dev, st, width=None):
    """Triangle-filtered lookup (mipmap.rs:132-149).

    width: (N,) filter width (max differential extent); None = finest level.
    """
    n_levels = dev["n_levels"]
    if width is None:
        level = jnp.zeros(st.shape[:-1], jnp.int32)
        return _bilerp_level(dev, level, st)
    level_f = n_levels - 1 + jnp.log2(jnp.maximum(width, 1e-8))
    level_f = jnp.clip(level_f, 0.0, n_levels - 1)
    l0 = jnp.floor(level_f).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    dt = (level_f - l0)[..., None]
    return (1 - dt) * _bilerp_level(dev, l0, st) + dt * _bilerp_level(dev, l1, st)


# ---- EWA anisotropic filtering (mipmap.rs:150-189) ----

_EWA_WINDOW = 16  # bounded ellipse scan per level (radii clamped to fit)
_EWA_LUT_SIZE = 128


def _ewa_weight(r2):
    """Gaussian falloff exp(-2 r^2) - exp(-2), matching the reference's
    weight LUT construction."""
    return jnp.maximum(jnp.exp(-2.0 * r2) - jnp.exp(-2.0), 0.0)


def _ewa_level(dev, level, st, dst0, dst1):
    """EWA at one (per-ray) level; st in [0,1)^2, dst* in uv units."""
    dims = take_rows(dev["dims"], level)
    h = dims[..., 0].astype(DTYPE)
    w = dims[..., 1].astype(DTYPE)
    wrap = dev["wrap"]
    stn = _st_norm(st, wrap)
    # convert to texel coordinates
    s = stn[..., 0] * w - 0.5
    t = stn[..., 1] * h - 0.5
    d0s = dst0[..., 0] * w
    d0t = dst0[..., 1] * h
    d1s = dst1[..., 0] * w
    d1t = dst1[..., 1] * h
    # ellipse coefficients (+1 blur like the reference)
    A = d0t * d0t + d1t * d1t + 1.0
    B = -2.0 * (d0s * d0t + d1s * d1t)
    C = d0s * d0s + d1s * d1s + 1.0
    inv_f = 1.0 / jnp.maximum(A * C - B * B * 0.25, 1e-12)
    A = A * inv_f
    B = B * inv_f
    C = C * inv_f
    det = jnp.maximum(-B * B + 4.0 * A * C, 1e-12)
    inv_det = 1.0 / det
    u_rad = jnp.sqrt(jnp.maximum(C * inv_det * 4.0, 0.0))
    v_rad = jnp.sqrt(jnp.maximum(A * inv_det * 4.0, 0.0))
    half = _EWA_WINDOW // 2
    u_rad = jnp.minimum(u_rad, half - 1.0)
    v_rad = jnp.minimum(v_rad, half - 1.0)
    s0 = jnp.ceil(s - u_rad).astype(jnp.int32)
    t0 = jnp.ceil(t - v_rad).astype(jnp.int32)

    # ONE window fetch per ray + vectorized weights over the 16x16
    # window (replaces a 256-iteration per-texel gather scan); rays
    # ride the minor axis throughout
    win = _window(dev, level, t0, s0, _EWA_WINDOW, _EWA_WINDOW)
    di = jnp.arange(_EWA_WINDOW, dtype=DTYPE)
    ss = (s0.astype(DTYPE)[None, :] + di[:, None]) - s[None, :]  # (Ws, N)
    tt = (t0.astype(DTYPE)[None, :] + di[:, None]) - t[None, :]  # (Wt, N)
    r2 = (
        A[None, None, :] * (ss * ss)[None, :, :]
        + B[None, None, :] * tt[:, None, :] * ss[None, :, :]
        + C[None, None, :] * (tt * tt)[:, None, :]
    )  # (Wt, Ws, N): axis 0 = t rows, axis 1 = s cols (window order)
    wgt = jnp.where(r2 < 1.0, _ewa_weight(r2), 0.0)
    if wrap == WRAP_BLACK:
        # zero the VALUES only: outside texels still contribute their
        # weight to wsum (matching the per-texel formulation)
        win = win * _black_mask(s0, t0, w, h, _EWA_WINDOW)[None]
    acc = jnp.sum(win * wgt[None], axis=(1, 2))  # (C, N)
    wsum = jnp.sum(wgt, axis=(0, 1))  # (N,)
    return acc.T / jnp.maximum(wsum, 1e-9)[..., None]


# ---- packed-pyramid (gather-free) lookups ----
#
# See MIPMap.as_packed: these lookups replace every texel access with ONE
# (N,128)@(128,Wc) row matmul whose 2-hot rows carry the t-lerp weights,
# then a channel-planar s-lerp reduction.  Exact (vs the window path) for
# every lookup landing at level >= lod_min; finer lookups clamp to
# lod_min (documented divergence from the reference's exact lookups,
# which trilinear_lookup / ewa_lookup keep).  The matmul runs at HIGHEST precision so the taps are
# exact float32 on every backend (a default-precision float32 matmul
# may round its operands to TF32 or bf16).
_MM = dict(precision=jax.lax.Precision.HIGHEST)


def _sel_meta(pk, level):
    """Per-ray (h, w, off) as f32/int select chains over the static level
    meta, with no per-ray table lookup."""
    metas = pk["meta"]
    h = jnp.full(level.shape, metas[-1][0], jnp.int32)
    w = jnp.full(level.shape, metas[-1][1], jnp.int32)
    off = jnp.full(level.shape, metas[-1][2], jnp.int32)
    for l in range(len(metas) - 2, -1, -1):
        sel = level <= l
        h = jnp.where(sel, metas[l][0], h)
        w = jnp.where(sel, metas[l][1], w)
        off = jnp.where(sel, metas[l][2], off)
    return h, w, off


def _packed_bilerp(pk, level, st):
    """Bilinear at continuous st on per-ray levels (>= lod_min each)."""
    h, w, off = _sel_meta(pk, level)
    hf = h.astype(DTYPE)
    wf = w.astype(DTYPE)
    wrap = pk["wrap"]
    wmax = pk["wmax"]
    c = pk["channels"]
    stn = _st_norm(st, wrap)
    s = stn[..., 0] * wf - 0.5
    t = stn[..., 1] * hf - 0.5
    s0 = jnp.floor(s).astype(jnp.int32)
    t0 = jnp.floor(t).astype(jnp.int32)
    ds = (s - s0.astype(DTYPE))[:, None]
    dt = (t - t0.astype(DTYPE))[:, None]
    s1 = s0 + 1
    t1 = t0 + 1
    one = jnp.ones_like(s0, bool)[:, None]
    if wrap == WRAP_REPEAT:
        # level dims are powers of two (build_mipmap pads): mod == mask,
        # correct for negatives too
        s0i, s1i = s0 & (w - 1), s1 & (w - 1)
        t0i, t1i = t0 & (h - 1), t1 & (h - 1)
        s0v = s1v = t0v = t1v = one
    elif wrap == WRAP_CLAMP:
        s0i = jnp.clip(s0, 0, w - 1)
        s1i = jnp.clip(s1, 0, w - 1)
        t0i = jnp.clip(t0, 0, h - 1)
        t1i = jnp.clip(t1, 0, h - 1)
        s0v = s1v = t0v = t1v = one
    else:  # WRAP_BLACK: out-of-image texels read as zero
        s0v = ((s0 >= 0) & (s0 < w))[:, None]
        s1v = ((s1 >= 0) & (s1 < w))[:, None]
        t0v = ((t0 >= 0) & (t0 < h))[:, None]
        t1v = ((t1 >= 0) & (t1 < h))[:, None]
        s0i = jnp.clip(s0, 0, w - 1)
        s1i = jnp.clip(s1, 0, w - 1)
        t0i = jnp.clip(t0, 0, h - 1)
        t1i = jnp.clip(t1, 0, h - 1)
    r0 = (off + t0i)[:, None]
    r1 = (off + t1i)[:, None]
    iota_r = jnp.arange(128, dtype=jnp.int32)[None, :]
    wr = (
        jnp.where((iota_r == r0) & t0v, 1.0 - dt, 0.0)
        + jnp.where((iota_r == r1) & t1v, dt, 0.0)
    ).astype(jnp.float32)
    m = jnp.matmul(wr, pk["table"], **_MM)  # (N, Wc): t-lerped level rows
    # channel-planar s-lerp: col = ch*wmax + s
    iota_s = jnp.arange(wmax, dtype=jnp.int32)[None, :]
    cw = (
        jnp.where((iota_s == s0i[:, None]) & s0v, 1.0 - ds, 0.0)
        + jnp.where((iota_s == s1i[:, None]) & s1v, ds, 0.0)
    ).astype(jnp.float32)
    n = m.shape[0]
    return jnp.sum(m.reshape(n, c, wmax) * cw[:, None, :], axis=-1)


def packed_trilinear_lookup(pk, st, width=None):
    """Triangle-filtered lookup on the packed coarse pyramid
    (mipmap.rs:132-149 semantics, levels clamped to >= lod_min)."""
    n_levels = pk["n_levels"]
    lod_min = pk["lod_min"]
    if width is None:
        level = jnp.full(st.shape[:-1], lod_min, jnp.int32)
        return _packed_bilerp(pk, level, st)
    level_f = n_levels - 1 + jnp.log2(jnp.maximum(width, 1e-8))
    level_f = jnp.clip(level_f, float(lod_min), n_levels - 1)
    l0 = jnp.floor(level_f).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    dt = (level_f - l0)[..., None]
    return (1 - dt) * _packed_bilerp(pk, l0, st) + dt * _packed_bilerp(
        pk, l1, st
    )


def packed_ewa_lookup(pk, st, dst0, dst1, max_aniso=8.0):
    """Anisotropic lookup on the packed pyramid.

    Level selection is EXACTLY ewa_lookup's (minor-axis radius after the
    max_aniso eccentricity clamp); the per-level filter is the bilerp tap
    instead of the elliptical Gaussian window (the sheared ellipse window
    cannot ride one row matmul — its column weights depend on the row).
    Divergence is filter sharpness only, bounded by one level's blur;
    ewa_lookup is the exact elliptical filter."""
    n_levels = pk["n_levels"]
    lod_min = pk["lod_min"]
    l0_sq = jnp.sum(dst0 * dst0, axis=-1)
    l1_sq = jnp.sum(dst1 * dst1, axis=-1)
    swap = l0_sq < l1_sq
    major = jnp.where(swap[..., None], dst1, dst0)
    minor_v = jnp.where(swap[..., None], dst0, dst1)
    major_len = jnp.sqrt(jnp.maximum(jnp.sum(major * major, -1), 1e-20))
    minor_len = jnp.sqrt(jnp.maximum(jnp.sum(minor_v * minor_v, -1), 0.0))
    scale = jnp.where(
        (minor_len * max_aniso < major_len) & (minor_len > 0.0),
        major_len / jnp.maximum(minor_len * max_aniso, 1e-20),
        1.0,
    )
    minor_len = minor_len * scale
    lod = jnp.clip(
        n_levels - 1 + jnp.log2(jnp.maximum(minor_len, 1e-9)),
        float(lod_min),
        n_levels - 1.0,
    )
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    dt = (lod - l0)[..., None]
    return (1 - dt) * _packed_bilerp(pk, l0, st) + dt * _packed_bilerp(
        pk, l1, st
    )


def ewa_lookup(dev, st, dst0, dst1, max_aniso=8.0):
    """Anisotropic lookup (mipmap.rs lookup_d): clamp eccentricity to
    max_aniso, choose the level from the minor radius, lerp two levels."""
    n_levels = dev["n_levels"]
    l0_sq = jnp.sum(dst0 * dst0, axis=-1)
    l1_sq = jnp.sum(dst1 * dst1, axis=-1)
    swap = l0_sq < l1_sq
    major = jnp.where(swap[..., None], dst1, dst0)
    minor_v = jnp.where(swap[..., None], dst0, dst1)
    major_len = jnp.sqrt(jnp.maximum(jnp.sum(major * major, -1), 1e-20))
    minor_len = jnp.sqrt(jnp.maximum(jnp.sum(minor_v * minor_v, -1), 0.0))
    scale = jnp.where(
        (minor_len * max_aniso < major_len) & (minor_len > 0.0),
        major_len / jnp.maximum(minor_len * max_aniso, 1e-20),
        1.0,
    )
    minor_v = minor_v * scale[..., None]
    minor_len = minor_len * scale
    degenerate = minor_len <= 1e-9

    lod = jnp.clip(
        n_levels - 1 + jnp.log2(jnp.maximum(minor_len, 1e-9)), 0.0, n_levels - 1.0
    )
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    dt = (lod - l0)[..., None]
    out = (1 - dt) * _ewa_level(dev, l0, st, major, minor_v) + dt * _ewa_level(
        dev, l1, st, major, minor_v
    )
    fallback = _bilerp_level(dev, jnp.zeros_like(l0), st)
    return jnp.where(degenerate[..., None], fallback, out)
