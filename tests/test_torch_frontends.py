"""The port's `frontends` (host numpy) against the JAX package's, exactly
(`np.array_equal`, packed buffers byte for byte), on the same seeded
inputs: the six packed formats' pack and unpack (v210's word layout and
row padding included), the deep / u8 helpers, the chroma resamplers,
ARGB (YCoCg lifting) and the RGB matrices, subsample / upsample / crop,
and the field split and weave in both field orders with the odd-height
ValueError."""
import numpy as np
import pytest

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import frontends as jf
from schroedinger_tpu_torch import frontends as tf

W, H = 60, 16   # v210 rows pad 60 pixels to 96


def _planes(seed, w=W, h=H, cw=W // 2, ch=H, dtype=np.uint8, top=255):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, top + 1, shape).astype(dtype)
                 for shape in ((h, w), (ch, cw), (ch, cw)))


def _same(a, b):
    if isinstance(a, (bytes, bytearray)):
        assert a == b
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


# (fourcc, planes maker): 4:2:2 u8, 4:4:4 u8, 4:2:2 10-bit, 4:2:2 and
# 4:4:4 16-bit
FORMATS = {
    "YUY2": lambda s: _planes(s),
    "YUYV": lambda s: _planes(s),
    "UYVY": lambda s: _planes(s),
    "AYUV": lambda s: _planes(s, cw=W),
    "v210": lambda s: _planes(s, dtype=np.uint16, top=1023),
    "v216": lambda s: _planes(s, dtype=np.uint16, top=65535),
    "AY64": lambda s: _planes(s, cw=W, dtype=np.uint16, top=65535),
}


@pytest.mark.parametrize("fourcc", sorted(FORMATS))
def test_pack_and_unpack_equal_jax(fourcc):
    planes = FORMATS[fourcc](3)
    packed = tf.pack_frame(planes, fourcc)
    _same(packed, jf.pack_frame(planes, fourcc))
    got = tf.unpack_frame(packed, fourcc, W, H)
    _same(got, jf.unpack_frame(packed, fourcc, W, H))
    _same(got, planes)
    # a random buffer unpacks to the same planes in both
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, len(packed), dtype=np.uint8).tobytes()
    _same(tf.unpack_frame(raw, fourcc, W, H),
          jf.unpack_frame(raw, fourcc, W, H))


@pytest.mark.parametrize("name,args", [
    ("pack_yuy2", lambda: FORMATS["YUY2"](5)),
    ("pack_uyvy", lambda: FORMATS["UYVY"](5)),
    ("pack_v216", lambda: FORMATS["v216"](5)),
    ("pack_v210", lambda: FORMATS["v210"](5)),
])
def test_pack_functions_equal_jax(name, args):
    planes = args()
    _same(getattr(tf, name)(*planes), getattr(jf, name)(*planes))


@pytest.mark.parametrize("alpha", [0, 255])
def test_alpha_formats_equal_jax(alpha):
    planes = FORMATS["AYUV"](6)
    _same(tf.pack_ayuv(*planes, alpha=alpha),
          jf.pack_ayuv(*planes, alpha=alpha))
    deep = FORMATS["AY64"](6)
    _same(tf.pack_ay64(*deep, alpha=alpha * 257),
          jf.pack_ay64(*deep, alpha=alpha * 257))


def test_v210_word_layout_and_row_padding():
    """One 6-pixel group per schrovirtframe.c:765-867, and rows padded to
    128-byte groups of 48 pixels, in both packages."""
    y = np.arange(1, 7, dtype=np.uint16)[None] * 100
    u = np.array([[11, 22, 33]], np.uint16)
    v = np.array([[44, 55, 66]], np.uint16)
    for w in (6, 47, 48, 49, 60):
        assert tf.v210_row_bytes(w) == jf.v210_row_bytes(w)
    packed = tf.pack_v210(y, u, v)
    assert packed == jf.pack_v210(y, u, v)
    assert len(packed) == tf.v210_row_bytes(6) == 128
    words = np.frombuffer(packed, "<u4")[:4]
    assert words[0] == 11 | (100 << 10) | (44 << 20)
    assert words[1] == 200 | (22 << 10) | (300 << 20)
    assert words[2] == 55 | (400 << 10) | (33 << 20)
    assert words[3] == 500 | (66 << 10) | (600 << 20)
    _same(tf.unpack_v210(packed, 6, 1), jf.unpack_v210(packed, 6, 1))


@pytest.mark.parametrize("bits", [10, 12, 16])
def test_deep_and_chroma_helpers_equal_jax(bits):
    y8 = _planes(1)[0]
    deep = tf.u8_to_deep(y8, bits)
    _same(deep, jf.u8_to_deep(y8, bits))
    _same(tf.deep_to_u8(deep, bits), jf.deep_to_u8(deep, bits))
    _same(tf.deep_to_u8(deep, bits), y8)
    u = _planes(2, cw=W // 2, ch=H + 1)[1]     # an odd row count too
    _same(tf.chroma_422_to_420(u), jf.chroma_422_to_420(u))
    _same(tf.chroma_420_to_422(u), jf.chroma_420_to_422(u))


def test_argb_equals_jax():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, W * H * 4, dtype=np.uint8).tobytes()
    ycocg = tf.unpack_argb(raw, W, H)
    _same(ycocg, jf.unpack_argb(raw, W, H))
    for alpha in (0xFF, 0x10):
        packed = tf.pack_argb(*ycocg, alpha=alpha)
        assert packed == jf.pack_argb(*ycocg, alpha=alpha)


@pytest.mark.parametrize("matrix", ["bt601", "bt709"])
def test_colour_matrices_equal_jax(matrix):
    rgb = _planes(7, cw=W)
    yuv = tf.rgb_to_yuv(*rgb, matrix=matrix)
    _same(yuv, jf.rgb_to_yuv(*rgb, matrix=matrix))
    _same(tf.yuv_to_rgb(*yuv, matrix=matrix),
          jf.yuv_to_rgb(*yuv, matrix=matrix))
    img = np.stack(rgb, axis=-1)
    p420 = tf.rgb_to_420(img, matrix)
    _same(p420, jf.rgb_to_420(img, matrix))
    _same(tf.yuv420_to_rgb(p420, matrix), jf.yuv420_to_rgb(p420, matrix))


@pytest.mark.parametrize("fmt", ["420", "422"])
def test_subsample_upsample_crop_equal_jax(fmt):
    p444 = _planes(8, cw=W)
    sub = tf.subsample_444(p444, fmt)
    _same(sub, jf.subsample_444(p444, fmt))
    _same(tf.upsample_to_444(sub, fmt), jf.upsample_to_444(sub, fmt))
    v_shift = 1 if fmt == "420" else 0
    _same(tf.crop(sub, 44, 10, 1, v_shift), jf.crop(sub, 44, 10, 1, v_shift))
    for mod in (tf, jf):
        with pytest.raises(ValueError):
            mod.subsample_444(p444, "411")
        with pytest.raises(ValueError):
            mod.upsample_to_444(sub, "411")


@pytest.mark.parametrize("tff", [True, False], ids=["tff", "bff"])
@pytest.mark.parametrize("chroma", ["420", "422"])
def test_split_and_weave_fields_equal_jax(tff, chroma):
    ch = H // 2 if chroma == "420" else H
    frame = _planes(10, ch=ch)
    f1, f2 = tf.split_fields(frame, tff=tff)
    j1, j2 = jf.split_fields(frame, tff=tff)
    _same(f1, j1)
    _same(f2, j2)
    assert f1[0].shape == (H // 2, W) and f1[1].shape == (ch // 2, W // 2)
    assert all(p.flags["C_CONTIGUOUS"] for p in f1 + f2)
    woven = tf.weave_fields(f1, f2, tff=tff)
    _same(woven, jf.weave_fields(j1, j2, tff=tff))
    _same(woven, frame)


def test_split_fields_refuses_odd_plane_heights():
    frame = _planes(11, h=14, ch=7)   # 4:2:0 chroma of a 14-row frame
    for mod in (tf, jf):
        with pytest.raises(ValueError, match="even plane heights"):
            mod.split_fields(frame)
