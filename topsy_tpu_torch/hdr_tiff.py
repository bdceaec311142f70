"""Minimal float16 TIFF I/O, with no tifffile dependency.

A pinned copy of ``topsy_tpu/hdr_tiff.py``: ``Visualizer.save('x.tiff')``
writes float16 RGB through tifffile where it is installed and through this
writer otherwise.  Classic little-endian TIFF, one uncompressed strip,
IEEE-float sample format, readable by any TIFF reader.
"""

from __future__ import annotations

import struct

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_SAMPLE_FORMAT = 339

_TYPE_SHORT = 3   # u16
_TYPE_LONG = 4    # u32

_SAMPLEFORMAT_IEEEFP = 3


def imwrite(filename: str, image: np.ndarray) -> None:
    """Write (H, W) or (H, W, C) float16 image as an uncompressed TIFF."""
    image = np.asarray(image, dtype=np.float16)
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3:
        raise ValueError(f"image must be 2-D or 3-D, got shape {image.shape}")
    h, w, c = image.shape
    data = np.ascontiguousarray(image).tobytes()

    data_off = 8
    bits_off = data_off + len(data)
    fmt_off = bits_off + 2 * c
    ifd_off = fmt_off + 2 * c
    # pad the IFD offset to even (TIFF requires word alignment)
    if ifd_off % 2:
        ifd_off += 1

    def short_val(v):
        return struct.pack("<HH", v, 0)

    def entry(tag, typ, count, value4):
        return struct.pack("<HHI", tag, typ, count) + value4

    if c == 1:
        bits = entry(_BITS_PER_SAMPLE, _TYPE_SHORT, 1, short_val(16))
        fmt = entry(_SAMPLE_FORMAT, _TYPE_SHORT, 1,
                    short_val(_SAMPLEFORMAT_IEEEFP))
    else:
        bits = entry(_BITS_PER_SAMPLE, _TYPE_SHORT, c,
                     struct.pack("<I", bits_off))
        fmt = entry(_SAMPLE_FORMAT, _TYPE_SHORT, c,
                    struct.pack("<I", fmt_off))

    entries = [
        entry(_IMAGE_WIDTH, _TYPE_LONG, 1, struct.pack("<I", w)),
        entry(_IMAGE_LENGTH, _TYPE_LONG, 1, struct.pack("<I", h)),
        bits,
        entry(_COMPRESSION, _TYPE_SHORT, 1, short_val(1)),
        entry(_PHOTOMETRIC, _TYPE_SHORT, 1, short_val(2 if c >= 3 else 1)),
        entry(_STRIP_OFFSETS, _TYPE_LONG, 1, struct.pack("<I", data_off)),
        entry(_SAMPLES_PER_PIXEL, _TYPE_SHORT, 1, short_val(c)),
        entry(_ROWS_PER_STRIP, _TYPE_LONG, 1, struct.pack("<I", h)),
        entry(_STRIP_BYTE_COUNTS, _TYPE_LONG, 1,
              struct.pack("<I", len(data))),
        entry(_PLANAR_CONFIG, _TYPE_SHORT, 1, short_val(1)),
        fmt,
    ]

    with open(filename, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_off))
        f.write(data)
        f.write(struct.pack("<%dH" % c, *([16] * c)))
        f.write(struct.pack("<%dH" % c, *([_SAMPLEFORMAT_IEEEFP] * c)))
        if f.tell() % 2:
            f.write(b"\0")
        f.write(struct.pack("<H", len(entries)))
        f.write(b"".join(entries))
        f.write(struct.pack("<I", 0))  # no next IFD


def imread(filename: str) -> np.ndarray:
    """Read a float16 TIFF written by imwrite (or any single-strip
    uncompressed little-endian IEEE-float16 TIFF)."""
    with open(filename, "rb") as f:
        blob = f.read()
    if blob[:2] != b"II" or struct.unpack("<H", blob[2:4])[0] != 42:
        raise ValueError("not a little-endian classic TIFF")
    (ifd_off,) = struct.unpack("<I", blob[4:8])
    (n_entries,) = struct.unpack("<H", blob[ifd_off:ifd_off + 2])
    tags = {}
    for i in range(n_entries):
        off = ifd_off + 2 + 12 * i
        tag, typ, count = struct.unpack("<HHI", blob[off:off + 8])
        value4 = blob[off + 8:off + 12]
        size = {_TYPE_SHORT: 2, _TYPE_LONG: 4}.get(typ)
        if size is None:
            continue
        if size * count <= 4:
            raw = value4[:size * count]
        else:
            (ext,) = struct.unpack("<I", value4)
            raw = blob[ext:ext + size * count]
        fmtc = "<%d%s" % (count, "H" if typ == _TYPE_SHORT else "I")
        tags[tag] = struct.unpack(fmtc, raw)
    w = tags[_IMAGE_WIDTH][0]
    h = tags[_IMAGE_LENGTH][0]
    c = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    if tags.get(_COMPRESSION, (1,))[0] != 1:
        raise ValueError("compressed TIFFs unsupported")
    if set(tags.get(_BITS_PER_SAMPLE, (16,))) != {16} or \
            set(tags.get(_SAMPLE_FORMAT, (_SAMPLEFORMAT_IEEEFP,))) != \
            {_SAMPLEFORMAT_IEEEFP}:
        raise ValueError("only float16 samples supported")
    offsets = tags[_STRIP_OFFSETS]
    counts = tags[_STRIP_BYTE_COUNTS]
    data = b"".join(blob[o:o + n] for o, n in zip(offsets, counts))
    arr = np.frombuffer(data, dtype="<f2").reshape(h, w, c)
    return arr[..., 0] if c == 1 else arr
