"""Image files: PNG encode/decode with the standard library, and image
loading as float arrays.

The JAX package reads and writes images with PIL (utils/general.py:85-99
`pil_to_array`, semantic_gui.py:86-96). This port encodes and decodes PNG
with zlib + struct, so a PNG dataset loads where PIL is absent: every
filter type (0-4), 8-bit gray, gray+alpha, RGB and RGBA, no interlace.
Other formats, palette or 16-bit PNGs, and any resize go through PIL when
it is importable, and otherwise raise naming the file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG color type → channels (8-bit)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W] (gray), [H,W,3] (RGB) or [H,W,4] (RGBA) → PNG bytes
    (8-bit, no interlace, filter type 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1).tobytes()
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


class UnsupportedPNG(ValueError):
    """A PNG this decoder does not read (palette, 16-bit, interlaced)."""


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (RFC 2083 §6): rows [H, 1 + W·bpp]
    with the filter byte first → [H, W·bpp] uint8."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prior = np.zeros(n, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        raw = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = raw
        elif ftype == 2:                                 # Up
            cur = (raw + prior) & 0xFF
        elif ftype == 1:                                 # Sub: running sums
            lanes = raw.reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)
        elif ftype in (3, 4):                            # Average, Paeth
            cur = np.zeros(n, np.int32)
            for x in range(0, n, bpp):
                up = prior[x:x + bpp]
                if x == 0:
                    left = upleft = np.zeros(bpp, np.int32)
                else:
                    left = cur[x - bpp:x]
                    upleft = prior[x - bpp:x]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - upleft))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                cur[x:x + bpp] = (raw[x:x + bpp] + pred) & 0xFF
        else:
            raise UnsupportedPNG(f"PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 [H, W, C] (C = 1 gray, 2 gray+alpha, 3 RGB,
    4 RGBA). Raises UnsupportedPNG for palette, 16-bit or interlaced
    images."""
    if data[:8] != _SIG:
        raise UnsupportedPNG("not a PNG")
    pos, idat = 8, []
    w = h = c = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ct, _, _, interlace = struct.unpack(">IIBBBBB",
                                                             body[:13])
            if depth != 8 or ct not in _CHANNELS or interlace:
                raise UnsupportedPNG(f"PNG bit depth {depth}, color type "
                                     f"{ct}, interlace {interlace}")
            c = _CHANNELS[ct]
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    if (rows[:, 0] == 0).all():
        return rows[:, 1:].reshape(h, w, c).copy()
    return _unfilter(rows, c).reshape(h, w, c)


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, C]: PNGs this module decodes without
    PIL; anything else through PIL, which must then be importable."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIG:
        try:
            return decode_png(data)
        except UnsupportedPNG:
            pass
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: not a PNG this package decodes (8-bit "
                           "gray/RGB/RGBA), and PIL is not installed") from e
    with Image.open(path) as im:
        if im.mode not in ("L", "LA", "RGB", "RGBA"):
            im = im.convert("RGBA" if "A" in im.getbands()
                            or "transparency" in im.info else "RGB")
        arr = np.array(im)
    return arr[..., None] if arr.ndim == 2 else arr


def load_image(path: str, resolution=None, resize_nearest: bool = False,
               scale: bool = True) -> np.ndarray:
    """Image file → float32 [H, W, C] in [0, 1] (raw values when
    scale=False), as the JAX package's pil_to_array(Image.open(path),
    resolution) gives it. resolution (W, H): a size other than the file's
    is resized by PIL (bicubic, or nearest), which must then be
    importable."""
    arr = read_image(path)
    if resolution is not None and (arr.shape[1], arr.shape[0]) != tuple(
            resolution):
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"{path}: resizing to {tuple(resolution)} "
                               "needs PIL, which is not installed") from e
        im = Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr)
        im = im.resize(tuple(resolution), Image.NEAREST if resize_nearest
                       else Image.BICUBIC)
        arr = np.array(im)
        arr = arr[..., None] if arr.ndim == 2 else arr
    return arr.astype(np.float32) / 255.0 if scale else arr
