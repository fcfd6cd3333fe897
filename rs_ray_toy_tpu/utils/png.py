"""Minimal PNG codec on the standard library's zlib.

Reads and writes 8-bit grayscale, RGB and RGBA images, not interlaced,
with all five scanline filter types on read (PNG spec, ISO/IEC 15948
section 9).  Any other PNG (palette, 16-bit, interlaced, ...) raises
ValueError.  Images are numpy uint8 arrays of shape (H, W) or (H, W, C).
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit only)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def encode_png(img):
    """uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) -> PNG bytes
    (filter type 0 on every row)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise ValueError(f"PNG writer takes gray, RGB or RGBA, got {a.shape}")
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return b"".join(
        [
            _SIGNATURE,
            _chunk(b"IHDR", ihdr),
            _chunk(b"IDAT", zlib.compress(rows.tobytes(), 9)),
            _chunk(b"IEND", b""),
        ]
    )


def write_png(path, img):
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, h, w, c):
    stride = w * c
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        row0 = y * (stride + 1)
        ftype = raw[row0]
        cur = raw[row0 + 1 : row0 + 1 + stride].astype(np.int32)
        if ftype == 0:
            rec = cur
        elif ftype == 1:
            rec = (np.cumsum(cur.reshape(w, c), axis=0) & 0xFF).reshape(-1)
        elif ftype == 2:
            rec = (cur + prev) & 0xFF
        elif ftype in (3, 4):
            # these predict from the reconstructed left pixel: sequential
            # over the pixels of the row, vectorized over its channels
            cur2, up = cur.reshape(w, c), prev.reshape(w, c)
            rec2 = np.zeros((w, c), np.int32)
            left = upleft = np.zeros(c, np.int32)
            for x in range(w):
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], upleft)
                left = rec2[x] = (cur2[x] + pred) & 0xFF
                upleft = up[x]
            rec = rec2.reshape(-1)
        else:
            raise ValueError(f"PNG: bad filter type {ftype} on row {y}")
        out[y] = rec
        prev = rec
    return out.astype(np.uint8)


def decode_png(data):
    """PNG bytes -> uint8 (H, W, C) with C = 1, 3 or 4."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: missing IHDR")
    w, h, depth, color_type, _, _, interlace = ihdr
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color_type}, "
            f"interlace {interlace}): only 8-bit gray, RGB or RGBA, "
            "not interlaced"
        )
    c = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError("PNG: image data has the wrong length")
    return _unfilter(raw, h, w, c).reshape(h, w, c)


def read_png(path):
    with open(path, "rb") as fh:
        return decode_png(fh.read())
