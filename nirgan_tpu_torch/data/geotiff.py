"""Self-contained GeoTIFF I/O (no rasterio/GDAL): the port's own copy of
``nirgan_tpu/data/geotiff.py``.

The reference's only surviving disk loader is rasterio-based
(``data/SR_dataset_RGB.py:29-43``: 4-band uint16 read,
DN/10000, centroid → EPSG:4326).  Neither rasterio nor tifffile exists in
this image, so this module implements the needed subset directly:

  * :func:`read_geotiff` — classic (non-Big) TIFF, both byte orders,
    uncompressed, DEFLATE (zlib/Adobe), LZW (MSB-first, early-change),
    PackBits, ZSTD (tag 50000, GDAL convention, via the system libzstd
    through ctypes), or new-style JPEG (tag 7, baseline 8-bit, abbreviated
    streams merged with the ``JPEGTables`` tag, decoded via Pillow's
    bundled libjpeg) — the lossless codecs each with the
    horizontal-differencing predictor, striped or tiled, chunky or planar,
    uint8/uint16/float32 samples; returns a CHW array plus the
    georeferencing (``ModelPixelScaleTag``/``ModelTiepointTag``) and the
    EPSG code from the ``GeoKeyDirectoryTag``.
  * :func:`write_geotiff` — minimal striped chunky writer (used by tests and
    dataset-synthesis tooling).
  * :func:`centroid_lonlat` — raster centroid → (lon, lat) in EPSG:4326.
    UTM zones (EPSG 326xx/327xx) are inverted with a WGS84 transverse
    Mercator series (sub-millimetre vs PROJ for in-zone points); EPSG 4326
    passes through.  This covers every CRS the reference datasets use
    (Sentinel-2/Landsat tiles are UTM; coords feed a ~100 km-scale location
    encoder, so series-order error is irrelevant).

A C++ twin of the read path lives in ``native/tileio.cc`` for the threaded
input pipeline; this module is the reference implementation both are tested
against.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["read_geotiff", "read_geotiff_meta", "write_geotiff",
           "centroid_lonlat", "pixel_lonlat", "utm_to_lonlat"]

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_PREDICTOR = 317
_SAMPLE_FORMAT = 339
_JPEG_TABLES = 347
_YCBCR_SUBSAMPLING = 530
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             13: "I", 16: "Q", 17: "q", 18: "Q"}  # 13/16-18: IFD + BigTIFF


# -------------------------------------------------------------- compression
#
# TIFF LZW (compression=5): MSB-first bit packing, 9→12-bit codes,
# ClearCode=256, EOI=257, with the "early change" convention (the code width
# grows one code earlier than plain LZW — libtiff/GDAL semantics).  PackBits
# (compression=32773) is the classic run-length byte scheme.

def _lzw_decode(data: bytes) -> bytes:
    out = bytearray()
    n_bits = len(data) * 8
    width, next_code, bitpos = 9, 258, 0
    table: list = []
    prev = b""

    def read_code() -> int:
        nonlocal bitpos
        if bitpos + width > n_bits:
            return 257  # ran off the end: treat as EOI (truncated stream)
        byte0 = bitpos >> 3
        chunk = int.from_bytes(data[byte0:byte0 + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        return code

    while True:
        code = read_code()
        if code == 257:  # EOI
            break
        if code == 256:  # Clear
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width, next_code, prev = 9, 258, b""
            continue
        if not table:
            raise ValueError("LZW stream does not start with a Clear code")
        if not prev:
            entry = table[code]
        else:
            if code < next_code:
                entry = table[code]
            elif code == next_code:
                entry = prev + prev[:1]
            else:
                raise ValueError("corrupt LZW stream")
            table.append(prev + entry[:1])
            next_code += 1
            # early change: widen one code before the table index overflows
            if next_code == (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = entry
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    out = bytearray()
    acc, n_acc, width = 0, 0, 9

    def emit(code: int):
        nonlocal acc, n_acc
        acc = (acc << width) | code
        n_acc += width
        while n_acc >= 8:
            n_acc -= 8
            out.append((acc >> n_acc) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(256)  # Clear
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        # the decoder's table lags the encoder's by one entry, so with the
        # early-change convention the encoder widens at 1<<width where the
        # decoder widens at (1<<width)-1
        if next_code == 4094:  # table nearly full → reset (early-change slot)
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            next_code, width = 258, 9
        elif next_code == (1 << width) and width < 12:
            width += 1
        w = bytes([byte])
    if w:
        emit(table[w])
    emit(257)  # EOI
    if n_acc:
        out.append((acc << (8 - n_acc)) & 0xFF)
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:  # literal run of h+1 bytes
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:  # repeat next byte 257-h times
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        lit = i
        while (i < n and i - lit < 128
               and not (i + 2 < n and data[i] == data[i + 1] == data[i + 2])):
            i += 1
        out += bytes([i - lit - 1]) + data[lit:i]
    return bytes(out)


_DECODERS = {5: _lzw_decode, 32773: _packbits_decode}


# ZSTD (compression=50000, the GDAL/libtiff private tag) — no Python zstd
# binding exists in this image, so bind the system libzstd's one-shot API
# through ctypes.  GDAL writes frames with the content size recorded, so
# ZSTD_getFrameContentSize normally sizes the output exactly; streaming
# frames without it fall back to the caller's expected segment size.

_zstd_cached = None
_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1  # -2 is ZSTD_CONTENTSIZE_ERROR


def _zstd():
    global _zstd_cached
    if _zstd_cached is None:
        import ctypes
        import ctypes.util
        import os

        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        # RTLD_DEEPBIND: several wheels in this image (tensorflow — pulled in
        # by the TensorBoard logger — and Pillow) bundle their own libzstd
        # builds with default symbol visibility.  Without DEEPBIND the system
        # libzstd's *internal* cross-calls go through its PLT and resolve
        # against whichever copy entered the global scope first, mixing CCtx
        # struct layouts across zstd versions (observed: streaming
        # compression dying with "sequence producer failed" after importing
        # tensorflow).  DEEPBIND pins the library to its own symbols.
        lib = ctypes.CDLL(name, mode=getattr(os, "RTLD_DEEPBIND", 0)
                          | ctypes.RTLD_LOCAL)
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_uint64
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _zstd_cached = lib
    return _zstd_cached


def _zstd_decode(data: bytes, expect_hint: int) -> bytes:
    import ctypes

    lib = _zstd()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size >= _ZSTD_CONTENTSIZE_UNKNOWN - 1:  # unknown/error: trust caller
        size = expect_hint
    out = ctypes.create_string_buffer(max(int(size), 1))
    n = lib.ZSTD_decompress(out, len(out), data, len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("corrupt ZSTD stream in TIFF segment")
    return out.raw[:n]


def _zstd_encode(data: bytes, level: int = 9) -> bytes:
    import ctypes

    lib = _zstd()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(max(int(bound), 1))
    n = lib.ZSTD_compress(out, len(out), data, len(data), level)
    if lib.ZSTD_isError(n):
        raise ValueError("ZSTD_compress failed")
    return out.raw[:n]


# New-style JPEG-in-TIFF (compression=7): each strip/tile is a JPEG stream,
# usually abbreviated — quantisation/Huffman tables live once in the
# JPEGTables tag (347) and must be spliced in after the segment's SOI.
# Decoding goes through Pillow (baked into this image); the stream is
# self-describing (component ids distinguish RGB- from YCbCr-coded data,
# grayscale is 1-component), so the TIFF photometric tag is not needed.

def _jpeg_decode(stream: bytes, tables) -> np.ndarray:
    import io

    from PIL import Image

    if tables and len(tables) > 4 and stream[:2] == b"\xff\xd8":
        stream = stream[:2] + bytes(tables)[2:-2] + stream[2:]
    arr = np.asarray(Image.open(io.BytesIO(stream)))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _jpeg_encode(arr_hwc: np.ndarray, quality: int) -> bytes:
    import io

    from PIL import Image

    if arr_hwc.shape[2] == 1:
        im = Image.fromarray(arr_hwc[:, :, 0], "L")
    elif arr_hwc.shape[2] == 3:
        im = Image.fromarray(arr_hwc, "RGB")
    else:
        raise ValueError("JPEG compression supports 1 or 3 samples per "
                         "segment (use planar=True for other band counts)")
    bio = io.BytesIO()
    # subsampling=0 → 4:4:4, matching the YCbCrSubSampling (1, 1) tag the
    # writer emits for 3-channel chunky images
    im.save(bio, "jpeg", quality=quality, subsampling=0)
    return bio.getvalue()


def _read_ifd(buf: bytes, bo: str, big: bool = False) -> Dict[int, tuple]:
    """Parse the first IFD — classic TIFF (u32 offsets, 12-byte entries) or
    BigTIFF (``big=True``: u64 offsets, 20-byte entries, LONG8 value
    types), which is what >4 GB satellite mosaics ship as."""
    if big:
        (ifd_off,) = struct.unpack(bo + "Q", buf[8:16])
        (n_entries,) = struct.unpack(bo + "Q", buf[ifd_off:ifd_off + 8])
        base, entry_sz, cap, off_fmt = ifd_off + 8, 20, 8, "Q"
    else:
        (ifd_off,) = struct.unpack(bo + "I", buf[4:8])
        (n_entries,) = struct.unpack(bo + "H", buf[ifd_off:ifd_off + 2])
        base, entry_sz, cap, off_fmt = ifd_off + 2, 12, 4, "I"
    tags: Dict[int, tuple] = {}
    for i in range(n_entries):
        e = base + entry_sz * i
        if big:
            tag, typ, count = struct.unpack(bo + "HHQ", buf[e:e + 12])
            vpos = e + 12
        else:
            tag, typ, count = struct.unpack(bo + "HHI", buf[e:e + 8])
            vpos = e + 8
        if typ not in _TYPE_FMT and typ != 7:
            continue
        size = _TYPE_SIZES[typ] * count
        if size <= cap:
            raw = buf[vpos:vpos + size]
        else:
            (off,) = struct.unpack(bo + off_fmt, buf[vpos:vpos + cap])
            raw = buf[off:off + size]
        if typ == 7:  # UNDEFINED — raw bytes (JPEGTables)
            tags[tag] = raw
            continue
        if typ == 5:  # RATIONAL — unused by us
            continue
        vals = struct.unpack(bo + str(count) + _TYPE_FMT[typ], raw)
        tags[tag] = vals
    return tags


def _geo_meta(tags: dict, width: int, height: int) -> dict:
    """Shared geo-metadata extraction (full reader + header-only reader):
    pixel scale, tiepoint, and EPSG with the 3072-over-2048 precedence."""
    meta = {"width": width, "height": height}
    if _MODEL_PIXEL_SCALE in tags:
        meta["pixel_scale"] = tags[_MODEL_PIXEL_SCALE][:2]
    if _MODEL_TIEPOINT in tags:
        meta["tiepoint"] = tags[_MODEL_TIEPOINT][:6]
    if _GEO_KEY_DIRECTORY in tags:
        gk = tags[_GEO_KEY_DIRECTORY]
        for i in range(4, len(gk), 4):
            key_id, loc, cnt, val = gk[i:i + 4]
            # ProjectedCSTypeGeoKey (3072) wins over GeographicTypeGeoKey (2048)
            if key_id == 3072 and loc == 0:
                meta["epsg"] = val
            elif key_id == 2048 and loc == 0 and "epsg" not in meta:
                meta["epsg"] = val
    return meta


def read_geotiff(path: str, dn_scale: Optional[float] = None,
                 native_dtype: bool = False):
    """Returns ``(img_chw float32, meta)``.

    ``meta``: dict with optional keys ``pixel_scale`` (sx, sy), ``tiepoint``
    (i, j, k, x, y, z), ``epsg`` (int), ``width``, ``height``.
    ``dn_scale``: when given, integer samples are divided by it (the
    reference's DN/10000); float inputs pass through unscaled.
    ``native_dtype``: return the raster's own dtype unscaled (uint16 DN stays
    uint16 — half the host→device bytes on the serving path, scaled on
    device); ``dn_scale`` is ignored.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    (magic,) = struct.unpack(bo + "H", buf[2:4])
    if magic not in (42, 43):
        raise ValueError(f"{path}: unsupported TIFF variant (magic={magic})")
    big = magic == 43
    if big and struct.unpack(bo + "H", buf[4:6])[0] != 8:
        raise ValueError(f"{path}: BigTIFF with non-8-byte offsets")
    tags = _read_ifd(buf, bo, big)

    width = tags[_IMAGE_WIDTH][0]
    height = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    bps = tags.get(_BITS_PER_SAMPLE, (1,))[0]
    comp = tags.get(_COMPRESSION, (1,))[0]
    planar = tags.get(_PLANAR_CONFIG, (1,))[0]
    sfmt = tags.get(_SAMPLE_FORMAT, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    # none / LZW / JPEG / DEFLATE / PackBits / Adobe-DEFLATE / ZSTD
    if comp not in (1, 5, 7, 8, 32773, 32946, 50000):
        raise ValueError(f"{path}: compression={comp} not supported "
                         "(install rasterio for CCITT/LERC exotics)")
    if predictor not in (1, 2) or (predictor == 2 and comp == 7):
        raise ValueError(f"{path}: predictor={predictor} not supported")
    if comp == 7 and (sfmt, bps) != (1, 8):
        raise ValueError(f"{path}: JPEG-in-TIFF is 8-bit only "
                         f"(got sample format {sfmt}, {bps} bits)")
    jpeg_tables = tags.get(_JPEG_TABLES)
    dtype = {(1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
             (2, 16): np.int16, (2, 32): np.int32,
             (3, 32): np.float32, (3, 64): np.float64}.get((sfmt, bps))
    if dtype is None:
        raise ValueError(f"{path}: unsupported sample format/bits ({sfmt}, {bps})")
    dt = np.dtype(dtype).newbyteorder(bo)

    def segment(off, cnt, n_items, seg_w, seg_spp):
        """Decode one strip/tile: raw bytes → (optionally inflated,
        un-predicted) sample array of ``n_items`` values."""
        if comp == 1:
            arr = np.frombuffer(buf, dt, n_items, off)
        elif comp == 7:
            n_rows = n_items // (seg_w * seg_spp)
            dec = _jpeg_decode(bytes(buf[off:off + cnt]), jpeg_tables)
            if dec.shape[2] != seg_spp:
                raise ValueError(f"{path}: JPEG segment has {dec.shape[2]} "
                                 f"components, TIFF tags say {seg_spp}")
            # JPEG dims may exceed the segment (MCU padding): crop; short
            # decodes zero-fill like the other codecs
            full = np.zeros((n_rows, seg_w, seg_spp), np.uint8)
            h_, w_ = min(n_rows, dec.shape[0]), min(seg_w, dec.shape[1])
            full[:h_, :w_] = dec[:h_, :w_]
            return full.reshape(-1)
        else:
            if comp in _DECODERS:
                raw = _DECODERS[comp](buf[off:off + cnt])
            elif comp == 50000:
                raw = _zstd_decode(bytes(buf[off:off + cnt]),
                                   n_items * dt.itemsize)
            else:
                import zlib

                raw = zlib.decompress(buf[off:off + cnt])
            arr = np.frombuffer(raw, dt, min(n_items, len(raw) // dt.itemsize))
        if predictor == 2:
            rows_ = arr.reshape(-1, seg_w, seg_spp)
            # horizontal differencing: integrate along the row, wrapping in
            # the sample dtype (TIFF predictor-2 semantics)
            arr = np.cumsum(rows_, axis=1, dtype=dt.base).reshape(-1)
        return arr

    if _TILE_OFFSETS in tags:
        tw, tl = tags[_TILE_WIDTH][0], tags[_TILE_LENGTH][0]
        offs, counts = tags[_TILE_OFFSETS], tags[_TILE_BYTE_COUNTS]
        tiles_x = (width + tw - 1) // tw
        tiles_y = (height + tl - 1) // tl
        if planar == 1:
            img = np.zeros((height, width, spp), dt.base)
            for t, (off, cnt) in enumerate(zip(offs, counts)):
                ty, tx = divmod(t, tiles_x)
                tile = segment(off, cnt, tl * tw * spp, tw, spp).reshape(tl, tw, spp)
                y0, x0 = ty * tl, tx * tw
                img[y0:y0 + tl, x0:x0 + tw] = tile[:height - y0, :width - x0]
            chw = np.transpose(img, (2, 0, 1))
        else:  # planar == 2: tiles per channel plane
            per = tiles_x * tiles_y
            chw = np.zeros((spp, height, width), dt.base)
            for t, (off, cnt) in enumerate(zip(offs, counts)):
                c, rem = divmod(t, per)
                ty, tx = divmod(rem, tiles_x)
                tile = segment(off, cnt, tl * tw, tw, 1).reshape(tl, tw)
                y0, x0 = ty * tl, tx * tw
                chw[c, y0:y0 + tl, x0:x0 + tw] = tile[:height - y0, :width - x0]
    else:
        offs, counts = tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS]
        rps = tags.get(_ROWS_PER_STRIP, (height,))[0]
        if planar == 1:
            rows = []
            for s, (off, cnt) in enumerate(zip(offs, counts)):
                n_rows = min(rps, height - s * rps)
                rows.append(segment(off, cnt, n_rows * width * spp, width, spp))
            flat = np.concatenate(rows).reshape(height, width, spp)
            chw = np.transpose(flat, (2, 0, 1))
        else:  # planar == 2: strips run through channel planes in order
            strips_per_plane = (height + rps - 1) // rps
            planes = []
            for c in range(spp):
                rows = []
                for s in range(strips_per_plane):
                    i = c * strips_per_plane + s
                    n_rows = min(rps, height - s * rps)
                    rows.append(segment(offs[i], counts[i], n_rows * width,
                                        width, 1))
                planes.append(np.concatenate(rows).reshape(height, width))
            chw = np.stack(planes)

    if native_dtype:
        return np.ascontiguousarray(chw), _geo_meta(tags, width, height)
    img = np.ascontiguousarray(chw).astype(np.float32)
    if dn_scale and np.issubdtype(dtype, np.integer):
        img /= float(dn_scale)

    return img, _geo_meta(tags, width, height)


def write_geotiff(path: str, img_chw: np.ndarray, *,
                  pixel_scale: Tuple[float, float] = (10.0, 10.0),
                  origin: Tuple[float, float] = (0.0, 0.0),
                  epsg: int = 4326, planar: bool = False,
                  rows_per_strip: Optional[int] = None,
                  deflate: bool = False, predictor: bool = False,
                  compression: Optional[str] = None,
                  jpeg_quality: int = 95, bigtiff: bool = False) -> None:
    """Minimal little-endian GeoTIFF writer (chunky or planar striped,
    optional DEFLATE / LZW / PackBits / ZSTD with the horizontal-differencing
    predictor, or lossy new-style JPEG for uint8 data).  ``origin`` is the
    (x, y) of the raster's top-left corner; ``deflate=True`` is shorthand
    for ``compression='deflate'``.  JPEG strips are self-contained 4:4:4
    streams (no JPEGTables tag); chunky 3-channel images get photometric
    YCbCr + a (1, 1) subsampling tag, everything else BlackIsZero.
    ``bigtiff=True`` emits the BigTIFF layout (magic 43, u64 offsets,
    LONG8 strip offsets/counts) — required once a mosaic passes 4 GB."""
    if compression is None:
        compression = "deflate" if deflate else "none"
    comp_tag = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773,
                "zstd": 50000, "jpeg": 7}[compression]
    img = np.ascontiguousarray(img_chw)
    c, h, w = img.shape
    if compression == "jpeg":
        if img.dtype != np.uint8:
            raise ValueError("JPEG compression requires uint8 samples")
        if predictor:
            raise ValueError("JPEG compression does not combine with the "
                             "horizontal-differencing predictor")
    if img.dtype == np.uint8:
        bps, sfmt = 8, 1
    elif img.dtype == np.uint16:
        bps, sfmt = 16, 1
    elif img.dtype == np.float32:
        bps, sfmt = 32, 3
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")
    itemsize = bps // 8
    rps = rows_per_strip or h

    def encode(rows_arr, seg_spp):
        arr = rows_arr
        if compression == "jpeg":
            return _jpeg_encode(arr.reshape(arr.shape[0], w, seg_spp),
                                jpeg_quality)
        if predictor:
            arr = arr.reshape(arr.shape[0], w, seg_spp)
            arr = np.concatenate([arr[:, :1], np.diff(arr, axis=1)], axis=1)
        data = np.ascontiguousarray(arr).tobytes()
        if compression == "deflate":
            import zlib

            data = zlib.compress(data)
        elif compression == "lzw":
            data = _lzw_encode(data)
        elif compression == "packbits":
            data = _packbits_encode(data)
        elif compression == "zstd":
            data = _zstd_encode(data)
        return data

    if planar:
        strips = []
        for i in range(c):
            plane = np.ascontiguousarray(img[i])
            for y0 in range(0, h, rps):
                strips.append(encode(plane[y0:y0 + rps], 1))
    else:
        hwc = np.ascontiguousarray(np.transpose(img, (1, 2, 0)))
        strips = [encode(hwc[y0:y0 + rps], c) for y0 in range(0, h, rps)]

    # 3 keys: GTModelType, GTRasterType (PixelIsArea), geodetic/projected CRS
    # — the count in the header must match the entries (GDAL reads count*4
    # uint16s and would run past a short directory)
    geo_dir = np.asarray([1, 1, 0, 3,
                          1024, 0, 1, 2 if epsg == 4326 else 1,
                          1025, 0, 1, 1,
                          (2048 if epsg == 4326 else 3072), 0, 1, epsg],
                         np.uint16)
    pixel_scale_d = np.asarray([pixel_scale[0], pixel_scale[1], 0.0], np.float64)
    tiepoint_d = np.asarray([0, 0, 0, origin[0], origin[1], 0], np.float64)

    entries = []  # (tag, type, count, value_bytes or int)
    def add(tag, typ, vals):
        entries.append((tag, typ, vals))

    off_typ = 16 if bigtiff else 4  # LONG8 vs LONG strip offsets/counts
    add(_IMAGE_WIDTH, 4, [w])
    add(_IMAGE_LENGTH, 4, [h])
    add(_BITS_PER_SAMPLE, 3, [bps] * c)
    add(_COMPRESSION, 3, [comp_tag])
    if predictor:
        add(_PREDICTOR, 3, [2])
    if compression == "jpeg" and not planar and c == 3:
        add(262, 3, [6])  # photometric: YCbCr (what the JPEG streams code)
        add(_YCBCR_SUBSAMPLING, 3, [1, 1])  # 4:4:4 (subsampling=0 above)
    else:
        add(262, 3, [1])  # photometric: BlackIsZero
    add(_STRIP_OFFSETS, off_typ, [0] * len(strips))  # patched below
    add(_SAMPLES_PER_PIXEL, 3, [c])
    add(_ROWS_PER_STRIP, 4, [rps])
    add(_STRIP_BYTE_COUNTS, off_typ, [len(s) for s in strips])
    add(_PLANAR_CONFIG, 3, [2 if planar else 1])
    add(_SAMPLE_FORMAT, 3, [sfmt] * c)
    add(_MODEL_PIXEL_SCALE, 12, pixel_scale_d.tolist())
    add(_MODEL_TIEPOINT, 12, tiepoint_d.tolist())
    add(_GEO_KEY_DIRECTORY, 3, geo_dir.tolist())

    entries.sort(key=lambda e: e[0])
    n = len(entries)
    if bigtiff:
        header = struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16)
        cap, cnt_fmt, off_fmt = 8, "Q", "Q"  # inline capacity / count / off
        ifd_size = 8 + 20 * n + 8
    else:
        header = struct.pack("<2sHI", b"II", 42, 8)
        cap, cnt_fmt, off_fmt = 4, "H", "I"
        ifd_size = 2 + 12 * n + 4
    ext_off = len(header) + ifd_size  # overflow area starts after IFD
    ext = bytearray()
    fixed = []
    for tag, typ, vals in entries:
        fmt = _TYPE_FMT[typ]
        size = _TYPE_SIZES[typ] * len(vals)
        if size <= cap:
            raw = struct.pack("<" + str(len(vals)) + fmt,
                              *vals).ljust(cap, b"\0")
            fixed.append((tag, typ, len(vals), raw, None))
        else:
            fixed.append((tag, typ, len(vals), None, len(ext)))
            ext += struct.pack("<" + str(len(vals)) + fmt, *vals)
    data_off = ext_off + len(ext)
    # patch strip offsets now that layout is known
    strip_offs = []
    acc = data_off
    for s in strips:
        strip_offs.append(acc)
        acc += len(s)
    so_fmt = _TYPE_FMT[off_typ]
    out = bytearray(header)
    out += struct.pack("<" + cnt_fmt, n)
    for tag, typ, cnt, raw, extpos in fixed:
        if tag == _STRIP_OFFSETS:
            if _TYPE_SIZES[off_typ] * cnt <= cap:
                raw = struct.pack("<" + str(cnt) + so_fmt,
                                  *strip_offs).ljust(cap, b"\0")
                extpos = None
            else:
                raw = None
                # rewrite the placeholder in ext
                packed = struct.pack("<" + str(cnt) + so_fmt, *strip_offs)
                ext[extpos:extpos + len(packed)] = packed
        if raw is not None:
            out += struct.pack("<HH" + ("Q" if bigtiff else "I"),
                               tag, typ, cnt) + raw
        else:
            out += struct.pack("<HH" + ("QQ" if bigtiff else "II"),
                               tag, typ, cnt, ext_off + extpos)
    out += struct.pack("<" + off_fmt, 0)  # no next IFD
    out += ext
    for s in strips:
        out += s
    with open(path, "wb") as f:
        f.write(out)


# ------------------------------------------------------------------ CRS math

def utm_to_lonlat(epsg: int, x, y):
    """Inverse WGS84 transverse Mercator for UTM zones (EPSG 326xx north /
    327xx south), Krüger series order n⁴ (≲0.1 mm in-zone vs PROJ)."""
    zone = epsg % 100
    north = (epsg // 100) == 326
    if not (1 <= zone <= 60) or (epsg // 100) not in (326, 327):
        raise ValueError(f"EPSG:{epsg} is not a WGS84 UTM zone")
    a = 6378137.0
    f = 1 / 298.257223563
    k0 = 0.9996
    e2 = f * (2 - f)
    n_ = f / (2 - f)
    # meridian arc scaling
    A = a / (1 + n_) * (1 + n_**2 / 4 + n_**4 / 64)
    x = np.asarray(x, np.float64) - 500000.0
    y = np.asarray(y, np.float64)
    if not north:
        y = y - 10000000.0
    xi = y / (k0 * A)
    eta = x / (k0 * A)
    beta = [n_ / 2 - 2 * n_**2 / 3 + 37 * n_**3 / 96 - n_**4 / 360,
            n_**2 / 48 + n_**3 / 15 - 437 * n_**4 / 1440,
            17 * n_**3 / 480 - 37 * n_**4 / 840,
            4397 * n_**4 / 161280]
    xi_p, eta_p = xi, eta
    for j, b in enumerate(beta, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    delta = [2 * n_ - 2 * n_**2 / 3 - 2 * n_**3 + 116 * n_**4 / 45,
             7 * n_**2 / 3 - 8 * n_**3 / 5 - 227 * n_**4 / 45,
             56 * n_**3 / 15 - 136 * n_**4 / 35,
             4279 * n_**4 / 630]
    lat = chi
    for j, d in enumerate(delta, start=1):
        lat = lat + d * np.sin(2 * j * chi)
    lon0 = math.radians(zone * 6 - 183)
    lon = lon0 + np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.degrees(lon), np.degrees(lat)


def pixel_lonlat(meta: dict, row: float, col: float) -> Optional[np.ndarray]:
    """(row, col) pixel-center → (lon, lat) from :func:`read_geotiff`
    metadata (pixel-center convention, same as ``src.xy`` in rasterio).
    Returns None when the raster carries no georeferencing.  Used per tile
    window by the scene-synthesis pipeline (inference/scene.py)."""
    if "tiepoint" not in meta or "pixel_scale" not in meta:
        return None
    sx, sy = meta["pixel_scale"]
    _, _, _, ox, oy, _ = meta["tiepoint"]
    cx = ox + (col + 0.5) * sx
    cy = oy - (row + 0.5) * sy
    epsg = meta.get("epsg", 4326)
    if epsg == 4326:
        return np.asarray([cx, cy], np.float32)
    lon, lat = utm_to_lonlat(epsg, cx, cy)
    return np.asarray([float(lon), float(lat)], np.float32)


def centroid_lonlat(meta: dict) -> Optional[np.ndarray]:
    """Raster-centroid (lon, lat) from :func:`read_geotiff` metadata —
    mirrors ``src.xy(h//2, w//2)`` + warp at
    ``data/SR_dataset_RGB.py:31-37`` (pixel-center
    convention).  Returns None when the raster carries no georeferencing."""
    return pixel_lonlat(meta, meta["height"] // 2, meta["width"] // 2)


def read_geotiff_meta(path: str) -> dict:
    """Header-only metadata read (seeks, no pixel decode) — the cheap
    per-path pass the native input pipeline uses for coords while the C++
    workers decode pixels."""
    with open(path, "rb") as f:
        head = f.read(16)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError(f"{path}: not a TIFF")
        big = struct.unpack(bo + "H", head[2:4])[0] == 43
        if big:
            (ifd_off,) = struct.unpack(bo + "Q", head[8:16])
            f.seek(ifd_off)
            (n_entries,) = struct.unpack(bo + "Q", f.read(8))
            entry_sz, cap, off_fmt = 20, 8, "Q"
        else:
            (ifd_off,) = struct.unpack(bo + "I", head[4:8])
            f.seek(ifd_off)
            (n_entries,) = struct.unpack(bo + "H", f.read(2))
            entry_sz, cap, off_fmt = 12, 4, "I"
        entries = f.read(entry_sz * n_entries)
        tags: Dict[int, tuple] = {}
        deferred = []
        for i in range(n_entries):
            e = entries[entry_sz * i:entry_sz * (i + 1)]
            if big:
                tag, typ, count = struct.unpack(bo + "HHQ", e[:12])
                val = e[12:]
            else:
                tag, typ, count = struct.unpack(bo + "HHI", e[:8])
                val = e[8:]
            if typ not in _TYPE_FMT or typ == 5:
                continue
            size = _TYPE_SIZES[typ] * count
            if size <= cap:
                tags[tag] = struct.unpack(bo + str(count) + _TYPE_FMT[typ],
                                          val[:size])
            else:
                (off,) = struct.unpack(bo + off_fmt, val[:cap])
                deferred.append((tag, typ, count, size, off))
        for tag, typ, count, size, off in deferred:
            f.seek(off)
            tags[tag] = struct.unpack(bo + str(count) + _TYPE_FMT[typ],
                                      f.read(size))
    return _geo_meta(tags, tags[_IMAGE_WIDTH][0], tags[_IMAGE_LENGTH][0])
