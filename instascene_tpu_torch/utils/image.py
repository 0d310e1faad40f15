"""Image files: PNG encode/decode with the standard library, image
loading as float arrays, and the viewer's colour maps.

The JAX package reads and writes images with PIL (utils/general.py:85-99
`pil_to_array`, semantic_gui.py:86-96). This port encodes and decodes PNG
with zlib + struct, so a PNG dataset loads where PIL is absent: every
filter type (0-4), 8-bit gray, gray+alpha, RGB and RGBA, and 16-bit gray
(instance label maps, as PIL writes a uint16 array), no interlace. Other
formats, palette PNGs, and any resize go through PIL when it is importable,
and otherwise raise naming the file.

`colormap`, `render_net_image` and `mask_to_rgb` port
instascene_tpu/utils/image.py:11-50 with the tables of utils/colormaps.py in
place of matplotlib.
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
    """uint8 [H,W] (gray), [H,W,3] (RGB) or [H,W,4] (RGBA), or uint16
    [H,W] (16-bit gray) → PNG bytes (no interlace, filter type 0 on every
    row)."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth = 16
        img = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1, 1)
        color_type = 0
    elif img.dtype == np.uint8:
        depth = 8
        if img.ndim == 2:
            img = img[..., None]
        color_type = {1: 0, 3: 2, 4: 6}[img.shape[2]]
    else:
        raise ValueError(f"encode_png wants uint8, or 2-D uint16, got "
                         f"{img.dtype} {img.shape}")
    h, wb, c = img.shape
    w = wb if depth == 8 else wb // 2
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, wb * c)], axis=1).tobytes()
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                          color_type, 0, 0, 0))
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
    4 RGBA), or uint16 [H, W, 1] for 16-bit gray. Raises UnsupportedPNG for
    palette, other 16-bit or interlaced images."""
    if data[:8] != _SIG:
        raise UnsupportedPNG("not a PNG")
    pos, idat = 8, []
    w = h = c = None
    depth = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ct, _, _, interlace = struct.unpack(">IIBBBBB",
                                                             body[:13])
            if (depth not in (8, 16) or (depth == 16 and ct != 0)
                    or ct not in _CHANNELS or interlace):
                raise UnsupportedPNG(f"PNG bit depth {depth}, color type "
                                     f"{ct}, interlace {interlace}")
            c = _CHANNELS[ct]
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    bpp = c * depth // 8               # bytes per pixel
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    if (rows[:, 0] == 0).all():
        px = rows[:, 1:].copy()
    else:
        px = _unfilter(rows, bpp)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w, 1)
    return px.reshape(h, w, c)


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


def image_size(path: str):
    """(width, height) of an image file: a PNG's from its header, anything
    else through PIL."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _SIG and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    arr = read_image(path)
    return arr.shape[1], arr.shape[0]


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


def colormap(img) -> np.ndarray:
    """[H,W] → [H,W,3] float32 through turbo, clipped to [0, 1] first."""
    from .colormaps import TURBO, lookup
    x = np.clip(np.asarray(img, np.float32), 0, 1)
    return lookup(TURBO, x).astype(np.float32)


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array."""
    return (x.detach().cpu().numpy() if hasattr(x, "detach")
            else np.asarray(x))


def render_net_image(render_pkg: dict, render_items, render_mode, camera
                     ) -> np.ndarray:
    """The viewer's output map (reference image_utils.py:47-75): render
    (default), alpha, normal, depth or edge/curvature (turbo), by name or by
    index into render_items. Returns [H,W,3] float in [0, 1]."""
    output = render_items[render_mode].lower() if isinstance(
        render_mode, int) else str(render_mode).lower()
    if output == "alpha":
        net = np.repeat(as_numpy(render_pkg["rend_alpha"]), 3, axis=-1)
    elif output == "normal":
        net = as_numpy(render_pkg["rend_normal"]) * 0.5 + 0.5
    elif output == "depth":
        d = as_numpy(render_pkg["surf_depth"])[..., 0]
        net = colormap(d / max(float(d.max()), 1e-6))
    elif output in ("edge", "curvature"):
        d = as_numpy(render_pkg["surf_depth"])[..., 0]
        gy, gx = np.gradient(d)
        mag = np.sqrt(gx ** 2 + gy ** 2)
        net = colormap(mag / max(float(mag.max()), 1e-6))
    else:
        net = as_numpy(render_pkg["render"])
    return np.clip(net, 0, 1)


def mask_to_rgb(mask) -> np.ndarray:
    """Instance label map → uint8 RGB, hsv resampled to the label count
    (utils/contrastive_utils.py:119-125), normalized as matplotlib's
    Normalize(0, max label) does: integer maps of at most 2 bytes in
    float32, wider ones in float64."""
    from .colormaps import hsv_lut, lookup
    mask = np.asarray(mask)
    num = int(mask.max()) + 1
    vmax = max(num - 1, 1)
    x = mask.astype(np.promote_types(mask.dtype, np.float32)
                    if mask.dtype.kind in "biu" else mask.dtype)
    x /= (np.float32 if vmax < 2 ** 16 else np.float64)(vmax)
    return np.uint8(lookup(hsv_lut(max(num, 2)), x) * 255.0)
