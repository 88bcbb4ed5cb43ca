"""Packed-format frame frontends: YUY2/UYVY/AYUV/v210/v216/AY64 <-> planar.

Vectorized numpy analogs of the reference's virtual-frame pack/unpack lines
(schrovirtframe.c:617-940 unpack_*, :944-1297 pack_*).  These are host I/O
adapters: capture/playout hardware hands the encoder packed 4:2:2/4:4:4
buffers, and the planar planes these produce feed the encoder
directly.  8-bit formats produce u8 planes; v210/v216/AY64 produce u16
planes (10/16-bit samples) plus helpers to round to u8.

Layouts (all little-endian, per pixel pair unless noted):
  YUY2/YUYV: Y0 U  Y1 V          (4:2:2, u8)
  UYVY:      U  Y0 V  Y1         (4:2:2, u8)
  AYUV:      A  Y  U  V          (4:4:4, u8, per pixel)
  v216:      U  Y0 V  Y1 as 16-bit samples (4:2:2)
  v210:      10-bit samples, 3 per 32-bit word, 16 bytes per 6 pixels
             word0 = Cr0<<20 | Y0<<10 | Cb0,  word1 = Y2<<20 | Cb1<<10 | Y1,
             word2 = Cb2<<20 | Y3<<10 | Cr1,  word3 = Y5<<20 | Cr2<<10 | Y4
             (schrovirtframe.c:765-867)
  AY64:      A Y U V as 16-bit samples per pixel (4:4:4)

Whole copy of `schroedinger_tpu/frontends.py` (host numpy): the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def unpack_yuy2(data, width: int, height: int):
    """YUYV bytes -> (y, u, v) u8 planes, 4:2:2 (schrovirtframe.c:617-637)."""
    a = np.frombuffer(data, np.uint8).reshape(height, width * 2)
    return a[:, 0::2].copy(), a[:, 1::4].copy(), a[:, 3::4].copy()


def pack_yuy2(y, u, v) -> bytes:
    h, w = y.shape
    out = np.empty((h, w * 2), np.uint8)
    out[:, 0::2] = y
    out[:, 1::4] = u
    out[:, 3::4] = v
    return out.tobytes()


def unpack_uyvy(data, width: int, height: int):
    """UYVY bytes -> (y, u, v) u8 planes, 4:2:2 (schrovirtframe.c:640-660)."""
    a = np.frombuffer(data, np.uint8).reshape(height, width * 2)
    return a[:, 1::2].copy(), a[:, 0::4].copy(), a[:, 2::4].copy()


def pack_uyvy(y, u, v) -> bytes:
    h, w = y.shape
    out = np.empty((h, w * 2), np.uint8)
    out[:, 1::2] = y
    out[:, 0::4] = u
    out[:, 2::4] = v
    return out.tobytes()


def unpack_ayuv(data, width: int, height: int):
    """AYUV bytes -> (y, u, v) u8 4:4:4 planes; alpha dropped
    (schrovirtframe.c:663-690)."""
    a = np.frombuffer(data, np.uint8).reshape(height, width, 4)
    return a[..., 1].copy(), a[..., 2].copy(), a[..., 3].copy()


def pack_ayuv(y, u, v, alpha: int = 255) -> bytes:
    h, w = y.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = alpha
    out[..., 1] = y
    out[..., 2] = u
    out[..., 3] = v
    return out.tobytes()


def unpack_v216(data, width: int, height: int):
    """v216 bytes -> (y, u, v) u16 planes, 4:2:2 (schrovirtframe.c:866-893)."""
    a = np.frombuffer(data, "<u2").reshape(height, width * 2)
    return a[:, 1::2].copy(), a[:, 0::4].copy(), a[:, 2::4].copy()


def pack_v216(y, u, v) -> bytes:
    h, w = y.shape
    out = np.empty((h, w * 2), "<u2")
    out[:, 1::2] = y
    out[:, 0::4] = u
    out[:, 2::4] = v
    return out.tobytes()


def v210_row_bytes(width: int) -> int:
    """v210 rows are padded to 48-pixel (128-byte) groups."""
    return ((width + 47) // 48) * 128


def unpack_v210(data, width: int, height: int):
    """v210 bytes -> (y, u, v) u16 planes (10-bit values), 4:2:2.

    Word layout per 6-pixel group per schrovirtframe.c:765-867."""
    rb = v210_row_bytes(width)
    words = np.frombuffer(data, "<u4").reshape(height, rb // 4)
    g = words.reshape(height, -1, 4)     # 6-pixel groups
    s0 = (g & 0x3FF).astype(np.uint16)
    s1 = ((g >> 10) & 0x3FF).astype(np.uint16)
    s2 = ((g >> 20) & 0x3FF).astype(np.uint16)
    ng = g.shape[1]
    ys = np.empty((height, ng, 6), np.uint16)
    ys[..., 0] = s1[..., 0]
    ys[..., 1] = s0[..., 1]
    ys[..., 2] = s2[..., 1]
    ys[..., 3] = s1[..., 2]
    ys[..., 4] = s0[..., 3]
    ys[..., 5] = s2[..., 3]
    us = np.stack([s0[..., 0], s1[..., 1], s2[..., 2]], axis=-1)
    vs = np.stack([s2[..., 0], s0[..., 2], s1[..., 3]], axis=-1)
    y = ys.reshape(height, ng * 6)[:, :width]
    u = us.reshape(height, ng * 3)[:, :width // 2]
    v = vs.reshape(height, ng * 3)[:, :width // 2]
    return y.copy(), u.copy(), v.copy()


def pack_v210(y, u, v) -> bytes:
    """(y, u, v) u16 10-bit planes -> v210 bytes (rows padded to 128B)."""
    h, w = y.shape
    ng = ((w + 47) // 48) * 8            # 6-pixel groups per row
    ys = np.zeros((h, ng * 6), np.uint32)
    us = np.zeros((h, ng * 3), np.uint32)
    vs = np.zeros((h, ng * 3), np.uint32)
    ys[:, :w] = y
    us[:, :w // 2] = u
    vs[:, :w // 2] = v
    ys = ys.reshape(h, ng, 6)
    us = us.reshape(h, ng, 3)
    vs = vs.reshape(h, ng, 3)
    g = np.zeros((h, ng, 4), np.uint32)
    g[..., 0] = us[..., 0] | (ys[..., 0] << 10) | (vs[..., 0] << 20)
    g[..., 1] = ys[..., 1] | (us[..., 1] << 10) | (ys[..., 2] << 20)
    g[..., 2] = vs[..., 1] | (ys[..., 3] << 10) | (us[..., 2] << 20)
    g[..., 3] = ys[..., 4] | (vs[..., 2] << 10) | (ys[..., 5] << 20)
    return g.astype("<u4").tobytes()


def unpack_ay64(data, width: int, height: int):
    """AY64 bytes -> (y, u, v) u16 4:4:4 planes (schrovirtframe.c:735-762)."""
    a = np.frombuffer(data, "<u2").reshape(height, width, 4)
    return a[..., 1].copy(), a[..., 2].copy(), a[..., 3].copy()


def pack_ay64(y, u, v, alpha: int = 0xFFFF) -> bytes:
    h, w = y.shape
    out = np.empty((h, w, 4), "<u2")
    out[..., 0] = alpha
    out[..., 1] = y
    out[..., 2] = u
    out[..., 3] = v
    return out.tobytes()


def chroma_422_to_420(u):
    """Vertical 2x chroma decimation (averaging) for 4:2:2 -> 4:2:0 input."""
    u = np.asarray(u)
    h2 = u.shape[0] // 2 * 2
    return ((u[:h2:2].astype(np.uint32) + u[1:h2:2] + 1) >> 1).astype(u.dtype)


def chroma_420_to_422(u):
    """Vertical 2x chroma replication for 4:2:0 -> 4:2:2 output."""
    return np.repeat(np.asarray(u), 2, axis=0)


def deep_to_u8(plane, bits: int = 10):
    """Round a >8-bit plane to u8 (full-scale mapping, inverse of
    u8_to_deep's bit replication)."""
    hi = (1 << bits) - 1
    p = np.asarray(plane).astype(np.uint64)
    return ((p * 255 + hi // 2) // hi).clip(0, 255).astype(np.uint8)


def u8_to_deep(plane, bits: int = 10):
    """Scale a u8 plane up to a deeper bit depth (replicating top bits)."""
    p = np.asarray(plane).astype(np.uint16)
    return ((p << (bits - 8)) | (p >> (16 - bits))).astype(np.uint16)


# ---- RGB frontends (ARGB pack/unpack, colour matrix, crop, subsample) ----

def unpack_argb(data, width: int, height: int):
    """ARGB bytes -> (Y, Co, Cg) int16 planes, 4:4:4.

    Reference-exact integer lifting (schrovirtframe.c:692-731 unpack_argb,
    its YCoCg variant):
        Co = R - B;  t = B - ((R - B) >> 1);  Y = t + (G >> 1);  Cg = G - t
    Arithmetic shifts on negatives match C's int >>."""
    a = np.frombuffer(data, np.uint8).reshape(height, width, 4)
    r = a[..., 1].astype(np.int16)
    g = a[..., 2].astype(np.int16)
    b = a[..., 3].astype(np.int16)
    t = b - ((r - b) >> 1)
    return (t + (g >> 1)).astype(np.int16), (r - b).astype(np.int16), \
        (g - t).astype(np.int16)


def pack_argb(y, co, cg, alpha: int = 0xFF) -> bytes:
    """(Y, Co, Cg) int16 planes -> ARGB bytes (schrovirtframe.c:1264-1287
    pack_argb, exact integer ops incl. its u8 wrap on store):
        t = Y + (Cg >> 1);  B = t - (Co >> 1);  R = B + Co;  G = t + Cg"""
    y = np.asarray(y, np.int16)
    co = np.asarray(co, np.int16)
    cg = np.asarray(cg, np.int16)
    t = y + (cg >> 1)
    b = t - (co >> 1)
    h, w = y.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = alpha
    out[..., 1] = (b + co).astype(np.uint8)   # wraps like the C u8 store
    out[..., 2] = (t + cg).astype(np.uint8)
    out[..., 3] = b.astype(np.uint8)
    return out.tobytes()


# studio-range RGB->YCbCr rows ((m1, m2, m3), offset) per component
# (schrovirtframe.c:1375-1421 color_matrix carries the BT.601 set; BT.709
# derived the same way: 219/255- and 224/255-scaled standard coefficients)
_COLOR_MATRICES = {
    "bt601": (((0.25679, 0.50413, 0.097906), 16.0),
              ((-0.14822, -0.29099, 0.43922), 128.0),
              ((0.43922, -0.36779, -0.071427), 128.0)),
    "bt709": (((0.18259, 0.61423, 0.062008), 16.0),
              ((-0.10064, -0.33857, 0.43922), 128.0),
              ((0.43922, -0.39894, -0.040274), 128.0)),
}

# inverse (YCbCr studio -> RGB): (y_scale, cb_coef, cr_coef) per channel
_INV_MATRICES = {
    "bt601": ((1.16438, 0.0, 1.59603),
              (1.16438, -0.39176, -0.81297),
              (1.16438, 2.01723, 0.0)),
    "bt709": ((1.16438, 0.0, 1.79274),
              (1.16438, -0.21325, -0.53291),
              (1.16438, 2.11240, 0.0)),
}


def rgb_to_yuv(r, g, b, matrix: str = "bt601"):
    """RGB u8 planes -> studio-range (Y, Cb, Cr) u8 4:4:4 with the
    reference's floor(x + 0.5) rounding (schrovirtframe.c:1417-1419)."""
    rows = _COLOR_MATRICES[matrix]
    srcs = [np.asarray(p, np.float64) for p in (r, g, b)]
    out = []
    for (m1, m2, m3), offset in rows:
        v = np.floor(srcs[0] * m1 + srcs[1] * m2 + srcs[2] * m3
                     + offset + 0.5)
        out.append(np.clip(v, 0, 255).astype(np.uint8))
    return tuple(out)


def yuv_to_rgb(y, u, v, matrix: str = "bt601"):
    """Studio-range (Y, Cb, Cr) u8 4:4:4 -> RGB u8 planes (inverse of
    rgb_to_yuv, floor(x + 0.5) rounding, clipped)."""
    yf = np.asarray(y, np.float64) - 16.0
    cb = np.asarray(u, np.float64) - 128.0
    cr = np.asarray(v, np.float64) - 128.0
    out = []
    for ys, cbc, crc in _INV_MATRICES[matrix]:
        val = np.floor(ys * yf + cbc * cb + crc * cr + 0.5)
        out.append(np.clip(val, 0, 255).astype(np.uint8))
    return tuple(out)


def subsample_444(planes, target: str = "420"):
    """4:4:4 -> 4:2:2 / 4:2:0 by point sampling, exactly like the
    reference's convert_444_422/convert_444_420 virtual frames
    (schrovirtframe.c:1437-1476: dest[j] = src[2j], chroma line 2i)."""
    y, u, v = (np.asarray(p) for p in planes)
    if target == "422":
        return y, u[:, ::2].copy(), v[:, ::2].copy()
    if target == "420":
        return y, u[::2, ::2].copy(), v[::2, ::2].copy()
    raise ValueError(target)


def upsample_to_444(planes, source: str = "420"):
    """4:2:0 / 4:2:2 -> 4:4:4 by sample replication (the mirror of the
    point-sampled subsample; schrovirtframe.c convert_*_444 analogs)."""
    y, u, v = (np.asarray(p) for p in planes)
    if source == "420":
        u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)
        v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)
    elif source == "422":
        u = np.repeat(u, 2, axis=1)
        v = np.repeat(v, 2, axis=1)
    else:
        raise ValueError(source)
    h, w = y.shape
    return y, u[:h, :w], v[:h, :w]


def rgb_to_420(rgb, matrix: str = "bt601"):
    """(h, w, 3) RGB u8 image -> (y, u, v) u8 4:2:0 planes: colour matrix
    then point subsample — the full RGB source frontend."""
    rgb = np.asarray(rgb, np.uint8)
    yuv = rgb_to_yuv(rgb[..., 0], rgb[..., 1], rgb[..., 2], matrix)
    return subsample_444(yuv, "420")


def yuv420_to_rgb(planes, matrix: str = "bt601"):
    """(y, u, v) u8 4:2:0 planes -> (h, w, 3) RGB u8 image."""
    y, u, v = upsample_to_444(planes, "420")
    r, g, b = yuv_to_rgb(y, u, v, matrix)
    return np.stack([r, g, b], axis=-1)


def crop(planes, width: int, height: int, h_shift: int = 1,
         v_shift: int = 1):
    """Top-left crop to (width, height) with chroma dims scaled by the
    format shifts (schro_virt_frame_new_crop, schrovirtframe.c:1854-1880;
    the reference crops from the origin, no offset)."""
    y, u, v = (np.asarray(p) for p in planes)
    assert width <= y.shape[1] and height <= y.shape[0]
    cw, ch = width >> h_shift, height >> v_shift
    return (y[:height, :width].copy(), u[:ch, :cw].copy(),
            v[:ch, :cw].copy())


_UNPACK = {"YUY2": unpack_yuy2, "YUYV": unpack_yuy2, "UYVY": unpack_uyvy,
           "AYUV": unpack_ayuv, "v210": unpack_v210, "v216": unpack_v216,
           "AY64": unpack_ay64}
_PACK = {"YUY2": pack_yuy2, "YUYV": pack_yuy2, "UYVY": pack_uyvy,
         "AYUV": pack_ayuv, "v210": pack_v210, "v216": pack_v216,
         "AY64": pack_ay64}


def unpack_frame(data, fourcc: str, width: int, height: int):
    """Packed buffer -> (y, u, v) planes (dtype per format)."""
    return _UNPACK[fourcc](data, width, height)


def pack_frame(planes, fourcc: str) -> bytes:
    """(y, u, v) planes -> packed buffer."""
    return _PACK[fourcc](*planes)


def split_fields(planes, tff: bool = True):
    """Frame -> (first field, second field) planes by row parity
    (schro_frame_split_fields, schroframe.c).  tff: first field = top
    (even) rows."""
    if any(np.asarray(p).shape[0] % 2 for p in planes):
        raise ValueError("interlaced coding requires even plane heights")
    a, b = (0, 1) if tff else (1, 0)
    f1 = tuple(np.ascontiguousarray(np.asarray(p)[a::2]) for p in planes)
    f2 = tuple(np.ascontiguousarray(np.asarray(p)[b::2]) for p in planes)
    return f1, f2


def weave_fields(f1, f2, tff: bool = True):
    """(first field, second field) -> woven frame planes (inverse of
    split_fields)."""
    out = []
    for p1, p2 in zip(f1, f2):
        p1 = np.asarray(p1)
        p2 = np.asarray(p2)
        fr = np.empty((p1.shape[0] + p2.shape[0], p1.shape[1]), p1.dtype)
        if tff:
            fr[0::2] = p1
            fr[1::2] = p2
        else:
            fr[1::2] = p1
            fr[0::2] = p2
        out.append(fr)
    return tuple(out)
