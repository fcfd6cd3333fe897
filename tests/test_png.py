"""PNG codec (utils/png.py): round trips, all five filter types, and the
clear error on PNG kinds it does not read."""

import struct
import zlib

import numpy as np
import pytest

from rs_ray_toy_tpu.utils.png import decode_png, encode_png, read_png, write_png


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 1), (6, 9, 3), (4, 3, 4)])
def test_round_trip(shape, tmp_path):
    img = _image(shape)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    got = read_png(path)
    want = img if img.ndim == 3 else img[..., None]
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered_png(img, ftypes):
    """Encode img (H, W, C) with filter ftypes[y] on row y."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(int)
    out = bytearray()
    for y in range(h):
        f = ftypes[y]
        out.append(f)
        for i in range(w * c):
            a = raw[y, i - c] if i >= c else 0
            b = raw[y - 1, i] if y > 0 else 0
            cc = raw[y - 1, i - c] if (y > 0 and i >= c) else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][f]
            out.append((raw[y, i] - pred) % 256)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decodes_every_filter_type(channels):
    img = _image((10, 6, channels), seed=channels)
    data = _filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(decode_png(data), img)


def test_rejects_unsupported_png():
    good = encode_png(_image((2, 2, 3)))
    ihdr_at = 8 + 8  # signature, then the IHDR length and tag
    for depth, color, interlace in ((16, 2, 0), (8, 3, 0), (8, 2, 1)):
        body = struct.pack(">IIBBBBB", 2, 2, depth, color, 0, 0, interlace)
        bad = good[:ihdr_at] + body + good[ihdr_at + 13:]
        with pytest.raises(ValueError, match="unsupported PNG"):
            decode_png(bad)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2, 3), np.float32))
