"""Image export and import: PNG and PPM with the standard library, raw npy.

Frames are ``[H, W, 3]`` floats in [0, 1] (tensors on any device, or numpy
arrays), quantized by ``to_u8``. PNG is written as the JAX package's native
encoder writes it (native/src/image_io.cpp): one IDAT of zlib level 6 over
rows that each start with filter byte 0, in IHDR/IDAT/IEND chunks with
their CRC-32s. ``load_image`` reads binary P6 PPM and 8-bit RGB or RGBA
non-interlaced PNG with any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_image", "save_png", "save_ppm", "save_npy", "load_image", "to_u8"]

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_u8(img) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> contiguous u8 (clamped, rounded half up)."""
    a = _host(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(a)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def save_png(path, img) -> Path:
    path = Path(path)
    a = to_u8(img)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"save_png takes an [H, W, 3] image, got shape {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    path.write_bytes(_PNG_MAGIC + _chunk(b"IHDR", ihdr)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
    return path


def save_ppm(path, img) -> Path:
    path = Path(path)
    a = to_u8(img)
    h, w = a.shape[:2]
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + a.tobytes())
    return path


def save_npy(path, img) -> Path:
    """Raw (pre-quantization) radiance dump for exact comparisons."""
    path = Path(path)
    np.save(path, _host(img))
    return path


def _read_ppm(data: bytes) -> np.ndarray:
    # P6 header: magic, width, height, maxval, whitespace and comments allowed.
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    if tokens[0] != b"P6" or int(tokens[3]) != 255:
        raise ValueError(f"unsupported PPM: {tokens}")
    w, h = int(tokens[1]), int(tokens[2])
    pix = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos + 1)
    return pix.reshape(h, w, 3).copy()


def _unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One PNG scanline with its filter undone (PNG spec section 9)."""
    if kind == 0:
        return line.copy()
    if kind == 1:  # Sub: a running sum of each channel along the row, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:  # Up
        return line + prev
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    # Average and Paeth predict from the reconstructed left byte: one byte at a time.
    raw, up = line.tolist(), prev.tolist()
    cur = [0] * len(raw)
    for i, x in enumerate(raw):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def _read_png(data: bytes) -> np.ndarray:
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, bits, color_type, _, _, interlace = header
    if bits != 8 or color_type not in (2, 6) or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {bits}, colour type {color_type}, interlace "
            f"{interlace} (8-bit RGB or RGBA, not interlaced, is read)"
        )
    bpp = 3 if color_type == 2 else 4
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return np.ascontiguousarray(out.reshape(h, w, bpp)[..., :3])


def load_image(path) -> np.ndarray:
    """Load a .ppm (binary P6) or a PNG as ``[H, W, 3]`` uint8 (an alpha
    channel is dropped)."""
    path = Path(path)
    data = path.read_bytes()
    if path.suffix.lower() == ".ppm":
        return _read_ppm(data)
    return _read_png(data)


def save_image(path, img) -> Path:
    """Save by extension: .png, .ppm, or .npy."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".png":
        return save_png(path, img)
    if ext == ".ppm":
        return save_ppm(path, img)
    if ext == ".npy":
        return save_npy(path, img)
    raise ValueError(f"unsupported image extension: {ext!r}")
