"""Image files without an image library (port of the `_image_shape` and `cv2.imread`
uses of `sar_yolo_tpu/data/dataset.py`): the training machine has neither OpenCV
nor PIL.

* `image_shape`: (h, w) from the header of a PNG (IHDR, every chunk's CRC checked
  through IEND, as PIL's `verify` does), JPEG (the SOFn frame header) or BMP file;
  None where PIL could not open and verify the file, which the dataset drops.
* `imread`: the pixels of a PNG or JPEG file as `cv2.imread` returns them, BGR uint8.
  PNG: gray, gray + alpha, palette, RGB and RGBA, 1 to 16 bits (16-bit samples keep
  their high byte, alpha is dropped). JPEG: baseline and extended sequential Huffman
  (SOF0/SOF1), 8-bit, gray or three components (YCbCr, or RGB as libjpeg decides it),
  every sampling factor libjpeg-turbo accepts, restart intervals, turned by its Exif
  orientation as OpenCV turns it; pixel for pixel libjpeg-turbo's default decode
  (the islow IDCT, fancy upsampling, fixed-point YCbCr->BGR). None where the file
  is corrupt; a JPEG whose data ends early decodes as libjpeg pads it (grey).
* `decode_mjpeg_frame`: a Motion-JPEG video frame as `cv2.VideoCapture` decodes it
  through FFmpeg (its simple IDCT, then swscale's yuvj420p -> BGR), not as `cv2.imread`
  decodes the same bytes; three-component 4:2:0 frames only.
* Every other kind raises NotImplementedError: progressive, arithmetic-coded,
  lossless, 12-bit and CMYK/YCCK JPEG, BMP pixels, TIFF, WebP, GIF, PFM and
  interlaced PNG. They are not decoded here, and not dropped either.

PNG's row filters are undone by `csrc/png_unfilter.c` and JPEG is decoded by
`csrc/jpeg_decode.c`, each built by `utils/hostc.py` with the system C compiler at first use into
`sar_yolo_tpu_torch/build/` (cached under a hash of the source and flags) and called
through ctypes, which releases the GIL: loader threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.utils.hostc import CSRC, library

SOURCE = CSRC / "png_unfilter.c"
JPEG_SOURCE = CSRC / "jpeg_decode.c"
JPEG_ENCODE_SOURCE = CSRC / "jpeg_encode.c"
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) pairs a PNG may have; colour type -> samples per pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _kind(head: bytes) -> str | None:
    """The format named by a file's first bytes; None for bytes of no image format."""
    if head.startswith(_PNG_SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):  # the signature OpenCV and PIL check
        return "JPEG"
    if head.startswith(b"BM"):
        return "BMP"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:4] == b"GIF8":
        return "GIF"
    if head[:2] in (b"PF", b"Pf"):
        return "PFM"
    return None


def _png_chunks(data: bytes):
    """(type, body) of each chunk before IEND; ValueError where the file is truncated
    or a CRC does not match."""
    pos = len(_PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG")
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IEND":
            return
        end = pos + 12 + n
        if end > len(data):
            raise ValueError("truncated PNG")
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise ValueError(f"CRC error in the {ctype!r} chunk")
        yield ctype, body
        pos = end


def _png_header(chunks: list) -> tuple:
    """(width, height, bit depth, colour type, interlace) of a valid IHDR."""
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if depth not in _PNG_DEPTHS.get(ctype, ()) or w == 0 or h == 0:
        raise ValueError(f"bit depth {depth}, colour type {ctype}")
    return w, h, depth, ctype, interlace


def _jpeg_shape(data: bytes) -> tuple[int, int] | None:
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:  # no length field
            pos += 2
            continue
        if marker in (0xD9, 0xDA):  # end of image or start of scan before a frame header
            return None
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > len(data):
                return None
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return h, w
        pos += 2 + n
    return None


def _bmp_shape(data: bytes) -> tuple[int, int] | None:
    if len(data) < 26:
        return None
    header = struct.unpack("<I", data[14:18])[0]
    if header == 12:
        w, h = struct.unpack("<HH", data[18:22])
    elif header >= 40:
        w, h = struct.unpack("<ii", data[18:26])
    else:
        return None
    return abs(h), w


def image_shape(path) -> tuple[int, int] | None:
    """(h, w) of an image file from its header; None where the file is no readable
    image. A format whose header is not read here raises NotImplementedError."""
    data = Path(path).read_bytes()
    kind = _kind(data[:16])
    if kind is None:
        return None
    if kind == "PNG":
        try:
            w, h = _png_header(list(_png_chunks(data)))[:2]
        except ValueError:
            return None
        return h, w
    if kind == "JPEG":
        return _jpeg_shape(data)
    if kind == "BMP":
        return _bmp_shape(data)
    raise NotImplementedError(f"{path}: reading {kind} files is not part of this port yet")


def _unfilter(raw: bytes, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    lib = library(SOURCE, {"png_unfilter": ([ctypes.c_char_p, ctypes.c_void_p]
                                             + [ctypes.c_int] * 3, ctypes.c_int)})
    if len(raw) < rows * (row_bytes + 1):
        raise ValueError("truncated image data")
    out = np.empty((rows, row_bytes), np.uint8)
    if lib.png_unfilter(raw, out.ctypes.data, rows, row_bytes, bpp) != 0:
        raise ValueError("unknown PNG row filter")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes, BGR uint8 (h, w, 3), as `cv2.imread` gives them;
    ValueError where the file is corrupt."""
    chunks = list(_png_chunks(data))
    w, h, depth, ctype, interlace = _png_header(chunks)
    types = {t for t, _ in chunks}
    if interlace:
        raise NotImplementedError("decoding interlaced (Adam7) PNG is not part of this port yet")
    if b"eXIf" in types:  # OpenCV would turn the image by its orientation tag
        raise NotImplementedError("PNG with an eXIf chunk: its orientation is not applied here")
    try:
        raw = zlib.decompress(b"".join(body for t, body in chunks if t == b"IDAT"))
    except zlib.error as e:
        raise ValueError(f"corrupt image data: {e}") from e
    channels = _PNG_CHANNELS[ctype]
    bits = depth * channels
    rows = _unfilter(raw, h, (w * bits + 7) // 8, max(1, bits // 8))
    if depth == 16:
        px = rows.reshape(h, w, channels, 2)[..., 0]  # the high byte of each big-endian sample
    elif depth == 8:
        px = rows.reshape(h, w, channels)
    else:  # 1, 2 or 4 bits: one sample a pixel
        px = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        px = (px * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if ctype == 0:  # gray scaled to 8 bits, as libpng expands it
            px = px * np.uint8(255 // ((1 << depth) - 1))
        px = px[..., None]
    if ctype == 3:
        plte = next((body for t, body in chunks if t == b"PLTE"), None)
        if plte is None or len(plte) % 3:
            raise ValueError("palette image without a valid PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        n = len(plte) // 3
        palette[:n] = np.frombuffer(plte, np.uint8).reshape(n, 3)
        rgb = palette[px[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


# jpeg_decode.c's refusals (positive codes); -1 is a corrupt file
_JPEG_UNSUPPORTED = {1: "progressive", 2: "arithmetic-coded", 3: "12-bit (not 8-bit) precision",
                     4: "lossless", 5: "four-component (CMYK/YCCK)"}


def _exif_orientation(data: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in the file's first APP1 segment, read as
    OpenCV's ExifReader reads it (the TIFF header 6 bytes into the segment, either
    byte order); 1 where there is none."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD9, 0xDA):
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xE1:
            tiff = data[pos + 4 + 6:pos + 2 + n]
            if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
                return 1
            e = "<" if tiff[:2] == b"II" else ">"
            ifd = struct.unpack(e + "I", tiff[4:8])[0]
            if ifd + 2 > len(tiff):
                return 1
            for i in range(struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]):
                entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
                if len(entry) < 12:
                    break
                if struct.unpack(e + "H", entry[:2])[0] == 0x0112:
                    return struct.unpack(e + "H", entry[8:10])[0]
            return 1
        pos += 2 + n
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: 2 flips left-right, 3 turns 180 degrees, 4 flips
    up-down, 5 transposes, 6-8 transpose then flip left-right, both ways, up-down."""
    if 5 <= orientation <= 8:
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, flips) if flips else img)


# every entry point of jpeg_decode.c, bound when its library is first loaded
_JPEG_SIGNATURES = {
    "jpeg_header": ([ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "jpeg_decode": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p], ctypes.c_int),
    "mjpeg_decode": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p], ctypes.c_int)}


def decode_jpeg(data: bytes) -> np.ndarray:
    """The pixels of a JPEG file's bytes, BGR uint8 (h, w, 3), as `cv2.imread` gives them
    (its Exif orientation applied); ValueError where the file is corrupt."""
    lib = library(JPEG_SOURCE, _JPEG_SIGNATURES)
    h, w = ctypes.c_int(), ctypes.c_int()
    status = lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w))
    if status == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        status = lib.jpeg_decode(data, len(data), out.ctypes.data)
    if status in _JPEG_UNSUPPORTED:
        raise NotImplementedError(f"decoding {_JPEG_UNSUPPORTED[status]} JPEG is not part of "
                                  "this port yet")
    if status == 7:
        raise MemoryError("out of memory decoding a JPEG file")
    if status != 0:
        raise ValueError("corrupt JPEG file")
    return _orient(out, _exif_orientation(data))


def decode_mjpeg_frame(data: bytes) -> np.ndarray:
    """A Motion-JPEG video frame's pixels, BGR uint8 (h, w, 3), as `cv2.VideoCapture`
    gives them through FFmpeg (not as `cv2.imread` decodes the same bytes): FFmpeg's
    mjpeg decoder (simple_idct into 4:2:0 planes), then swscale's yuvj420p -> bgr24
    (`csrc/jpeg_decode.c`, `mjpeg_decode`). Frames that are not three-component 4:2:0,
    or under 2 pixels wide or high, raise NotImplementedError; a corrupt frame raises
    ValueError."""
    lib = library(JPEG_SOURCE, _JPEG_SIGNATURES)
    h, w = ctypes.c_int(), ctypes.c_int()
    status = lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w))
    if status == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        status = lib.mjpeg_decode(data, len(data), out.ctypes.data)
    if status == 6:
        raise NotImplementedError("Motion-JPEG frames other than three-component 4:2:0 of at "
                                  "least 2x2 pixels are not part of this port yet")
    if status in _JPEG_UNSUPPORTED:
        raise NotImplementedError(f"decoding {_JPEG_UNSUPPORTED[status]} Motion-JPEG frames is "
                                  "not part of this port yet")
    if status == 7:
        raise MemoryError("out of memory decoding a Motion-JPEG frame")
    if status != 0:
        raise ValueError("corrupt Motion-JPEG frame")
    return out


_DECODERS = {"PNG": decode_png, "JPEG": decode_jpeg}


def imread(path) -> np.ndarray | None:
    """`cv2.imread(path)` of a PNG or JPEG file: BGR uint8 (h, w, 3), or None where the
    file is no readable image. Other formats raise NotImplementedError."""
    data = Path(path).read_bytes()
    kind = _kind(data[:16])
    if kind is None:
        return None
    if kind not in _DECODERS:
        raise NotImplementedError(f"{path}: decoding {kind} files is not part of this port yet")
    try:
        return _DECODERS[kind](data)
    except ValueError:
        return None


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """`cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])[1]`, byte for byte as
    libjpeg-turbo writes it under OpenCV's defaults: baseline, 4:2:0 for a BGR image,
    one component for a 2-D one (`csrc/jpeg_encode.c`)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"encode_jpeg takes uint8 (h, w) or (h, w, 3) images, not "
                         f"{img.dtype} {img.shape}")
    lib = library(JPEG_ENCODE_SOURCE, {"jpeg_encode": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_long], ctypes.c_long)})
    h, w = img.shape[:2]
    channels = 3 if img.ndim == 3 and img.shape[2] == 3 else 1
    cap = h * w * channels + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data, h, w, channels, int(quality), out.ctypes.data, cap)
        if n == -2:
            raise MemoryError("out of memory encoding a JPEG image")
        if n < 0:
            raise ValueError(f"encode_jpeg cannot write a {w}x{h} image")
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """A PNG file of a uint8 BGR (h, w, 3) or gray (h, w) image, as `cv2.imwrite` takes it:
    8-bit RGB or gray, every row filter None, deflated by the standard library's zlib at
    OpenCV's default level 1. The bytes differ from OpenCV's (zlib version, filter choice);
    the pixels read back are the same."""
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes uint8 (h, w) or (h, w, 3) images, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rgb = img if img.ndim == 2 else img[..., ::-1]
    rows = np.zeros((h, 1 + rgb[0].size), np.uint8)
    rows[:, 1:] = rgb.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


_ENCODERS = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".png": encode_png}


def imwrite(path, img: np.ndarray) -> bool:
    """`cv2.imwrite(path, img)` of a uint8 BGR or gray image to a .jpg / .jpeg (quality 95)
    or .png file; other extensions raise NotImplementedError naming the format."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext not in _ENCODERS:
        raise NotImplementedError(f"{path}: writing {ext or 'extensionless'} images is not part "
                                  "of this port (JPEG and PNG are)")
    path.write_bytes(_ENCODERS[ext](img))
    return True
