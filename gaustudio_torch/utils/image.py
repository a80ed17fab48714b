"""Image IO: decoding as wide as the JAX package's, and a stdlib PNG codec.

:func:`load_image` is the counterpart of ``Camera.load_image``
(gaustudio_tpu/cameras/__init__.py): where PIL imports, it decodes through
PIL with ``ImageOps.exif_transpose``, as the JAX package does (JPEG, grey,
palette, 16-bit and every other format PIL opens). Where PIL does not
import, it reads PNGs with :func:`read_png`, from the standard library
(zlib + struct): non-interlaced 8-bit images of colour type 0 (grey), 2
(RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), with all five scanline
filters, converted as PIL's ``convert("RGB")`` converts them unless they are
RGBA. Anything else raises, naming PIL. :func:`write_png` stands in for PIL
in ``save_image`` (gaustudio_tpu/pipelines/mesh_extraction.py), grey images
included, and writes 16-bit grey depth maps. :func:`load_rgb8`,
:func:`load_grey8`, :func:`load_samples` and :func:`resize_linear_u8`
decode and resize as the JAX package's loaders do through OpenCV, which the
port does not use.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from gaustudio_torch.utils.observability import annotate

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel, by colour type


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey), [H, W, 3] or [H, W, 4] array, or a uint16
    [H, W] grey image such as a depth map in millimetres (16-bit samples,
    big-endian); filter 0 on every row."""
    pixels = np.asarray(pixels)
    if pixels.dtype == np.uint16 and pixels.ndim == 2:
        h, w = pixels.shape
        color_type, depth, row = 0, 16, pixels.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    else:
        pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
        if pixels.ndim == 2:
            pixels = pixels[..., None]
        if pixels.ndim != 3 or pixels.shape[2] not in (1, 3, 4):
            raise ValueError(f"expected [H, W] or [H, W, 3|4] pixels, got {pixels.shape}")
        h, w, c = pixels.shape
        color_type, depth, row = {1: 0, 3: 2, 4: 6}[c], 8, pixels.reshape(h, w * c)
    raw = np.zeros((h, 1 + row.shape[1]), np.uint8)
    raw[:, 1:] = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average / Paeth depend on the left byte
            cur = bytearray(stride)
            up = prev.tolist()
            src = line.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _png_parts(path: str):
    """A PNG's (IHDR fields, palette or None, decompressed scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file; other formats need PIL")
    pos = len(_SIGNATURE)
    idat = []
    header = palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    return header, palette, zlib.decompress(b"".join(idat))


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced PNG -> uint8 [H, W, 4] for RGBA, else [H, W, 3]:
    grey, grey + alpha and palette images become RGB as PIL's
    ``convert("RGB")`` makes them (alpha and palette transparency dropped;
    grey of 1, 2 or 4 bits scaled to 0..255). Samples are 8-bit, or 1, 2 or
    4 bits for grey and palette images."""
    (w, h, depth, color_type, _, _, interlace), palette, data = _png_parts(path)
    packed = color_type in (0, 3) and depth in (1, 2, 4)
    if not (depth == 8 or packed) or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: without PIL only non-interlaced grey, RGB, palette, grey + alpha and RGBA "
            f"PNGs of 8-bit samples are read (bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}); install PIL for the rest")
    c = _CHANNELS[color_type]
    raw = _unfilter(data, h, (w * c * depth + 7) // 8, max(1, c * depth // 8))
    if packed:  # one sample a pixel, depth bits each, rows padded to whole bytes
        bits = np.unpackbits(raw, axis=1)[:, :w * depth].reshape(h, w, depth)
        raw = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)
        if color_type == 0:
            raw *= 255 // ((1 << depth) - 1)
    pixels = raw.reshape(h, w, c)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)  # indices past the palette read black
        full[:len(palette)] = palette[:256]
        return full[pixels[..., 0]]
    if color_type in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return pixels


def save_image(path: str, array: np.ndarray) -> None:
    """[H, W, 3] or [H, W] float image in [0, 1] -> 8-bit RGB or grey PNG."""
    arr = np.clip(np.asarray(array) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, arr)


def save_rgb8(path: str, img: np.ndarray) -> None:
    """A uint8 RGB image to ``path`` through PIL, as the JAX package saves
    it; without PIL a PNG is written by the stdlib encoder and any other
    format raises, naming PIL."""
    try:
        from PIL import Image
    except ImportError:
        if not path.lower().endswith(".png"):
            raise ImportError(f"{path}: an image other than a PNG is written through PIL, "
                              "which does not import") from None
        write_png(path, img)
        return
    Image.fromarray(img).save(path)


def _decode(path: str) -> np.ndarray:
    """uint8 [H, W, 4] for an RGBA image, else [H, W, 3]: through PIL (with
    the EXIF orientation applied) where it imports, else through read_png."""
    try:
        from PIL import Image, ImageOps
    except ImportError:
        return read_png(path)
    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        return np.asarray(img if img.mode == "RGBA" else img.convert("RGB"))


def load_image(path: str, bg_color=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """An image file -> (float32 [H, W, 3] in [0, 1], alpha mask [H, W] or None).

    RGBA images are composited over ``bg_color`` (default black), as the JAX
    package's ``Camera.load_image`` does; every other mode is converted to RGB.
    """
    arr = _decode(path).astype(np.float32) / 255.0
    if arr.shape[2] == 3:
        return arr, None
    bg = np.zeros(3, np.float32) if bg_color is None else np.asarray(bg_color, np.float32)
    a = arr[..., 3:4]
    return arr[..., :3] * a + bg * (1.0 - a), a[..., 0]


def load_rgb8(path: str) -> np.ndarray:
    """uint8 [H, W, 3] of an image file, its alpha dropped (OpenCV's
    ``IMREAD_COLOR`` in RGB order)."""
    return _decode(path)[..., :3]


def load_grey8(path: str) -> np.ndarray:
    """uint8 [H, W]: a grey image's samples; other modes are converted to
    luma by PIL (OpenCV's ``IMREAD_GRAYSCALE`` may round a luma 1 apart)."""
    try:
        from PIL import Image, ImageOps
    except ImportError:
        return read_png(path)[..., 0]
    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        return np.asarray(img if img.mode == "L" else img.convert("L"))


def resize_linear_u8(m: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [h, w] -> [height, width], bilinear at pixel centres without
    antialiasing, rounded: OpenCV's ``resize`` (``INTER_LINEAR``) up to its
    fixed-point rounding, which may land one level apart."""
    import torch

    x = torch.from_numpy(m.astype(np.float32))[None, None]
    out = torch.nn.functional.interpolate(x, size=(height, width), mode="bilinear",
                                          align_corners=False, antialias=False)
    return torch.round(out[0, 0]).clamp(0, 255).to(torch.uint8).numpy()


def load_samples(path: str) -> np.ndarray:
    """An image's samples as stored (OpenCV's ``IMREAD_UNCHANGED``): uint16
    [H, W] for a 16-bit grey PNG such as a depth map in millimetres. Without
    PIL, 8- and 16-bit grey PNGs are read."""
    try:
        from PIL import Image
    except ImportError:
        (w, h, depth, color_type, _, _, interlace), _, data = _png_parts(path)
        if color_type != 0 or depth not in (8, 16) or interlace != 0:
            raise ValueError(f"{path}: without PIL only 8- and 16-bit grey PNGs are read "
                             f"as stored; install PIL for the rest")
        raw = _unfilter(data, h, w * depth // 8, depth // 8)
        return raw if depth == 8 else raw.view(">u2").astype(np.uint16)
    with Image.open(path) as img:
        return np.asarray(img)


WRITER_THREADS = 2
MAX_PENDING_WRITES = 8


class BackgroundWriter:
    """Runs file writes on WRITER_THREADS threads beside the caller's next
    device work (zlib and file IO release the interpreter lock), with at
    most MAX_PENDING_WRITES writes waiting. Leaving the ``with`` block waits
    for every write and raises the first one's error."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=WRITER_THREADS)
        self._pending = []

    def submit(self, fn, *args) -> None:
        if len(self._pending) >= MAX_PENDING_WRITES:
            with annotate("gs.mesh.writer_wait"):
                self._pending.pop(0).result()
        self._pending.append(self._pool.submit(fn, *args))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            with annotate("gs.mesh.writer_wait"):
                for f in self._pending:
                    f.result()
        finally:
            self._pool.shutdown()
