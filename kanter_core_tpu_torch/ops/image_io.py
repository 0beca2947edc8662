"""Host-side PNG decode and encode, without Pillow.

Port of `kanter_core_tpu/ops/image_io.py`, which decodes and encodes
through PIL; the port carries its own PNG codec on the standard library's
`zlib` and numpy, with the row unfilter in C (`csrc/host.c`).

Decoding gives the pixels the JAX package's `read_slot_image` gives, which
are PIL's after its mode conversion (every case below is pinned by
`tests/test_torch_image_io.py` against PIL):

- gray at 2, 4 and 8 bits: one channel, low depths scaled to 0–255 (PIL's
  "L"; a tRNS chunk is ignored); gray at 1 bit: RGBA, grey levels 0 or 255
  and alpha 0 where the sample equals the tRNS value (PIL's "1" converted
  to RGBA); gray at 16 bits: RGBA with the sample clipped to 255, and
  alpha 0 where the clipped sample equals the tRNS value (PIL's "I;16"
  converted to RGBA);
- RGB at 8 bits, and at 16 bits through the high byte of each sample (a
  tRNS chunk is ignored);
- palette at 1, 2, 4 and 8 bits: RGBA through PLTE and tRNS (indices past
  the palette, or every index without a PLTE, are black; past tRNS opaque);
- gray+alpha at 8 bits: two channels; at 16 bits: RGBA `[L, L, L, A]` of
  the high bytes (PIL's "LA;16B" mode is RGBA);
- RGBA at 8 bits, and at 16 bits through the high bytes;
- all five row filters, and Adam7 interlacing.

`deconstruct_image` then makes the four planes of `shared.rs:16-56`: each
channel `u8 / 255`, missing channels 0.0 and alpha 1.0 — including the
reference's `[L, A, 0, 1]` quirk for two channels. A file the codec cannot
read (another format, a bad signature, a chunk whose CRC fails, a corrupt
or short stream, more pixels than PIL's decompression-bomb limit) raises an
`IMAGE` error, which the Image node turns into
the 1×1 magenta placeholder (`image.rs:11-19`), as the JAX package does for
any decode failure.

Encoding writes 8-bit RGBA, every row with the Up filter, through `zlib`;
the bytes differ from PIL's, the decoded pixels do not. Only a `.png` path
is written: any other extension is an `IO` error (the JAX package lets PIL
pick another format, or raise a `ValueError` for an unknown one).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..errors import ErrorKind, TexProError

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (x0, y0, dx, dy) of the seven Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
# PIL's decompression-bomb limit (twice its MAX_IMAGE_PIXELS), past which the
# JAX package's decode fails too
MAX_PIXELS = 2 * 89_478_485
# samples per pixel of each colour type, and its allowed bit depths
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}


class PngError(ValueError):
    """A file the codec cannot read."""


def _chunks(data: bytes):
    """`(type, payload)` of every chunk up to IEND; the CRC of every chunk
    but IDAT is checked, as PIL checks them."""
    if data[:8] != PNG_SIGNATURE:
        raise PngError("not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise PngError("truncated PNG file")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise PngError(f"truncated {ctype!r} chunk")
        if ctype != b"IDAT" and struct.unpack(">I", crc)[0] != zlib.crc32(ctype + payload):
            raise PngError(f"bad CRC in {ctype!r} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length


def _header(payload: bytes) -> tuple:
    if len(payload) != 13:
        raise PngError("bad IHDR")
    w, h, depth, ctype, compression, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise PngError(f"colour type {ctype} at {depth} bits")
    if w == 0 or h == 0 or compression or filt or interlace > 1:
        raise PngError("bad IHDR")
    return w, h, depth, ctype, interlace


def _unfilter(raw: memoryview, rows: int, stride: int, bpp: int) -> np.ndarray:
    from ..build import host_library

    src = np.frombuffer(raw, np.uint8, rows * (stride + 1))
    out = np.empty((rows, stride), np.uint8)
    bad = host_library().kanter_png_unfilter(src.ctypes.data, out.ctypes.data, rows, stride, bpp)
    if bad:
        raise PngError(f"unknown filter type in row {bad - 1}")
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """`[h, width, channels]` samples (uint16 at 16 bits, else uint8 as
    stored) of unfiltered rows."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, -1)[:, :width * channels] \
            .reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return unpacked.reshape(h, -1)[:, :width].reshape(h, width, 1)


def _decode_samples(data: bytes) -> tuple:
    """`(samples [H, W, C], depth, colour type, PLTE, tRNS)` of a PNG."""
    header = plte = trns = None
    idat = []
    for ctype, payload in _chunks(data):
        if header is None:
            if ctype != b"IHDR":
                raise PngError("IHDR is not the first chunk")
            header = _header(payload)
        elif ctype == b"PLTE":
            plte = payload
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"IDAT":
            idat.append(payload)
    w, h, depth, ctype, interlace = header
    if w * h > MAX_PIXELS:
        raise PngError(f"{w}x{h} pixels exceed the decoder's limit")
    channels = _COLOR_TYPES[ctype][0]
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from e
    bits = channels * depth
    bpp = max(1, bits // 8)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        size = ph * (stride + 1)
        if pos + size > len(raw):
            raise PngError("image data too short")
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        pos += size
    return out, depth, ctype, plte, trns


def _trns_alpha(samples: np.ndarray, trns) -> np.ndarray:
    """255, or 0 where a gray sample (at 16 bits: clipped to 255) equals
    the tRNS value."""
    alpha = np.full(samples.shape, 255, np.uint8)
    if trns is not None and len(trns) >= 2:
        alpha[samples == struct.unpack(">H", trns[:2])[0]] = 0
    return alpha


def decode_png(data: bytes) -> np.ndarray:
    """The `[H, W, C]` u8 pixels of a PNG, as the JAX package's decode
    gives them (see the module docstring); raises `PngError`."""
    s, depth, ctype, plte, trns = _decode_samples(data)
    if ctype == 3:
        if plte is not None and len(plte) % 3:
            raise PngError("bad PLTE")
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        colors = np.frombuffer(plte or b"", np.uint8).reshape(-1, 3)[:256]
        palette[:len(colors), :3] = colors
        if trns is not None:
            palette[:min(len(trns), 256), 3] = np.frombuffer(trns, np.uint8)[:256]
        return palette[s[:, :, 0]]
    if ctype == 0 and depth == 1:
        g = s[:, :, 0]
        v = (g * 255).astype(np.uint8)
        return np.stack([v, v, v, _trns_alpha(g, trns)], axis=-1)
    if ctype == 0 and depth == 16:
        v = np.minimum(s[:, :, 0], 255).astype(np.uint8)
        return np.stack([v, v, v, _trns_alpha(v, trns)], axis=-1)
    if ctype == 0:
        return s * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16:
        hi = (s >> 8).astype(np.uint8)
        if ctype == 4:
            lum, alpha = hi[:, :, 0], hi[:, :, 1]
            return np.stack([lum, lum, lum, alpha], axis=-1)
        return hi
    return s


def deconstruct_image(pixels_u8: np.ndarray) -> list:
    """`[H, W, C]` u8 → four `[H, W]` f32 planes (missing → 0.0, alpha → 1.0)."""
    if pixels_u8.ndim == 2:
        pixels_u8 = pixels_u8[:, :, None]
    h, w, channel_count = pixels_u8.shape
    planes = []
    for c in range(4):
        if c < channel_count:
            planes.append(pixels_u8[:, :, c].astype(np.float32) / np.float32(255.0))
        elif c == 3:
            planes.append(np.ones((h, w), dtype=np.float32))
        else:
            planes.append(np.zeros((h, w), dtype=np.float32))
    return planes


def read_planes(path) -> list:
    """The four f32 planes of an image file (`shared.rs:218-261`); any
    read or decode failure is an `IMAGE` error."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        pixels = decode_png(data)
    except (OSError, ValueError) as e:
        raise TexProError(ErrorKind.IMAGE, str(e)) from e
    return deconstruct_image(pixels)


def magenta_planes() -> list:
    """The 1×1 magenta RGBA fallback of a failed load (`node/image.rs:13-18`)."""
    return [np.full((1, 1), v, dtype=np.float32) for v in (1.0, 0.0, 1.0, 1.0)]


def image_planes(path) -> list:
    """The Image node's planes: the file's, or magenta when it cannot be
    read."""
    try:
        return read_planes(path)
    except TexProError:
        return magenta_planes()


def encode_png(rgba_u8: np.ndarray) -> bytes:
    """An 8-bit RGBA PNG of `[H, W, 4]` u8 pixels: every row filtered with
    Up, deflated by `zlib`."""
    h, w, _ = rgba_u8.shape
    rows = np.ascontiguousarray(rgba_u8, np.uint8).reshape(h, w * 4)
    filtered = np.empty((h, w * 4 + 1), np.uint8)
    filtered[:, 0] = 2  # Up
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])  # wraps mod 256

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_rgba_png(path, rgba_u8_flat: np.ndarray, size) -> None:
    """Write flat interleaved RGBA u8 as a PNG (`node/write.rs:5-21`).
    Raises `ValueError` for a path whose extension is not `.png`, and
    `OSError` when the file cannot be written."""
    if os.path.splitext(os.fspath(path))[1].lower() != ".png":
        raise ValueError(f"only .png files are written, not {os.fspath(path)!r}")
    pixels = np.asarray(rgba_u8_flat, dtype=np.uint8).reshape(size.height, size.width, 4)
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)


def image_size(path) -> tuple:
    """`(width, height)` of an image file from its IHDR chunk alone, or
    `(1, 1)` (the placeholder's) when it cannot be read: the JAX package's
    `engine._image_size` (there read through PIL, and cached for its tiled
    route's capacity gate, which the port does not have yet)."""
    try:
        with open(path, "rb") as f:
            head = f.read(33)  # the signature and the IHDR chunk
        ctype, payload = next(_chunks(head))
        if ctype != b"IHDR":
            raise PngError("IHDR is not the first chunk")
        return _header(payload)[:2]
    except (OSError, ValueError, StopIteration):
        return (1, 1)
