"""Image IO: PNG read-write in numpy + zlib (stb_image equivalents),
Radiance .hdr, PFM.

Reference behaviors covered: stbi_load + y-flip for OBJ textures
(Model.cpp:88-135), stbi_loadf for HDR probes (main.cpp:146-156),
stbi_write_png for frame dumps (main.cpp:296-311).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples/pixel


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> PNG bytes (8-bit, filter 0)."""
    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        base = y * (stride + 1)
        kind = raw[base]
        line = np.frombuffer(raw, np.uint8, stride, base + 1).astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind in (3, 4):  # Average / Paeth depend on the decoded left byte
            cur = line.tolist()
            up = prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C = 1, 2, 3 or 4 (palettes expand to
    RGB or RGBA). Supports 8-bit, non-interlaced images."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    pos, idat, palette, trns = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace})")
    c = _PNG_CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)
    if color == 3:
        rgb = palette[px[..., 0]]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns
        return np.concatenate([rgb, alpha[px[..., 0]][..., None]], axis=-1)
    return px


def load_image(path: str, flip_y: bool = True) -> np.ndarray:
    """8-bit PNG -> (H, W, 3) float32 in [0,1]. flip_y matches the
    reference's texture convention (Model.cpp:116-125 mirrors stb rows)."""
    with open(path, "rb") as f:
        px = decode_png(f.read())
    if px.shape[-1] < 3:  # gray (+ alpha) -> RGB
        px = np.repeat(px[..., :1], 3, axis=-1)
    img = px[..., :3].astype(np.float32) / 255.0
    return img[::-1] if flip_y else img


def save_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3|4) uint8 or float in [0,1] -> PNG."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


# ---- Radiance .hdr (RGBE) ---------------------------------------------------

def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr -> (H, W, 3) float32 linear (stbi_loadf equivalent).

    Supports the common '-Y H +X W' orientation with new-style RLE scanlines.
    """
    with open(path, "rb") as f:
        data = f.read()

    # header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    header_end = pos
    # resolution line
    nl = data.index(b"\n", header_end)
    res_line = data[header_end:nl].decode("ascii").split()
    pos = nl + 1
    if len(res_line) != 4 or res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {' '.join(res_line)}")
    h, w = int(res_line[1]), int(res_line[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    idx = 0
    for y in range(h):
        # new-style RLE scanline: 0x02 0x02 hi lo (hi/lo must encode the
        # width — a flat pixel can also start with 0x02 0x02)
        if (
            w >= 8
            and w < 32768
            and raw[idx] == 2
            and raw[idx + 1] == 2
            and (int(raw[idx + 2]) << 8 | int(raw[idx + 3])) == w
        ):
            idx += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(raw[idx])
                    idx += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = raw[idx]
                        idx += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = raw[idx : idx + count]
                        idx += count
                        x += count
        else:  # flat scanline
            row = raw[idx : idx + 4 * w].reshape(w, 4)
            rgbe[y] = row
            idx += 4 * w

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 2^(e-128)/256
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] == 0, 0.0, 1.0
    )


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W, 4) RGBE bytes (shared-exponent encode)."""
    m = img.max(axis=-1)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    mant, exp = np.frexp(np.maximum(m, 0.0))
    valid = m > 1e-32
    s = np.where(valid, mant * 256.0 / np.maximum(m, 1e-32), 0.0)
    out[..., 0] = np.clip(img[..., 0] * s, 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(img[..., 1] * s, 0, 255).astype(np.uint8)
    out[..., 2] = np.clip(img[..., 2] * s, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    return out


def save_hdr(path: str, img: np.ndarray) -> None:
    """(H, W, 3) float32 -> uncompressed Radiance .hdr."""
    h, w = img.shape[:2]
    rgbe = float_to_rgbe(np.asarray(img, np.float32))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---- PFM (the reference's BSDFTest output format) ---------------------------

def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(img[::-1].tobytes())


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if kind == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)[::-1]
    return img.squeeze()
