import numpy as np

import struct
import zlib

import pytest

from optixpathtracer.io.image import (
    decode_png,
    encode_png,
    load_hdr,
    load_image,
    load_pfm,
    save_hdr,
    save_pfm,
    save_png,
)


def test_hdr_roundtrip(tmp_path, rng):
    img = (rng.random((16, 32, 3)) * 8.0).astype(np.float32)
    p = str(tmp_path / "t.hdr")
    save_hdr(p, img)
    back = load_hdr(p)
    assert back.shape == img.shape
    # RGBE shares one exponent across channels: absolute error is bounded by
    # one mantissa step of the per-pixel max channel
    step = img.max(axis=-1, keepdims=True) / 256.0
    assert np.all(np.abs(back - img) <= step + 1e-4)


def test_pfm_roundtrip(tmp_path, rng):
    img = rng.random((8, 12, 3)).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    save_pfm(p, img)
    np.testing.assert_allclose(load_pfm(p), img, rtol=1e-6)


def test_png_roundtrip(tmp_path, rng):
    img = rng.random((10, 14, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    save_png(p, img)
    back = load_image(p, flip_y=False)
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-3)


def test_texture_yflip(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    img[0, :] = 1.0  # top row white
    p = str(tmp_path / "f.png")
    save_png(p, img)
    flipped = load_image(p, flip_y=True)
    assert flipped[-1].mean() > 0.9  # top row moved to bottom (Model.cpp:118-125)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_round_trip(rng, channels):
    img = (rng.random((13, 7, channels)) * 255).astype(np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def test_png_decodes_every_filter_and_palettes(rng):
    """Rows filtered with Sub, Up, Average and Paeth (what other encoders
    write), and a palette image with transparency, decode exactly."""
    h, w, c = 5, 6, 3
    img = (rng.random((h, w, c)) * 255).astype(np.uint8)
    raw = img.reshape(h, w * c).astype(int)
    out = b""
    for y in range(h):
        kind = y % 5
        prev = raw[y - 1] if y else np.zeros(w * c, int)
        row = []
        for x in range(w * c):
            a = raw[y, x - c] if x >= c else 0
            b, cc = prev[x], (prev[x - c] if x >= c else 0)
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][kind]
            row.append((raw[y, x] - pred) & 0xFF)
        out += bytes([kind] + row)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    sig = b"\x89PNG\r\n\x1a\n"
    png = (sig + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(decode_png(png), img)

    pal = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8)
    idx = rng.integers(0, 3, (4, 4)).astype(np.uint8)
    rows = b"".join(b"\x00" + bytes(r) for r in idx)
    png = (sig + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0))
           + chunk(b"PLTE", pal.tobytes()) + chunk(b"tRNS", bytes([0, 255]))
           + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    rgba = decode_png(png)
    np.testing.assert_array_equal(rgba[..., :3], pal[idx])
    np.testing.assert_array_equal(rgba[..., 3], np.where(idx == 0, 0, 255))
