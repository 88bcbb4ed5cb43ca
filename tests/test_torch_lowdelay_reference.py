"""The port's VC-2 low-delay and deep intra paths held to the standard
without the JAX package, on the CPU at 128x64:

- `pipeline.make_lowdelay_analyze` equals `benchmark/ldref.py`, the plain
  PyTorch reference of the analysis written from ST 2042-1 and the
  reference encoder's quantiser, with torch.equal (the slices and the
  61-base bit and last-nonzero tables) on seeded random planes;
- `benchmark/vc2spec.py`, the NumPy decoder written from the standard's
  decoding process, decodes the port's low-delay streams to the port's
  own decode, sample for sample;
- the native coder's slices packed on its pool's threads are the bytes
  it packs on the calling thread alone;
- a deep vc2_main intra picture is centred as the standard centres it:
  a picture at 2^(bit depth - 1) codes every subband empty, and a
  lossless picture decodes to its source through the port's decoder.

Both benchmark modules are loaded by path: they are the benchmark's
copies and the repository's only ones.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from schroedinger_tpu_torch import api, pipeline
from schroedinger_tpu_torch.config import EncoderConfig
from schroedinger_tpu_torch.coding import native
from schroedinger_tpu_torch.encoder import intra as ei_intra
from schroedinger_tpu_torch.encoder import lowdelay as loe
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.video_format import ChromaFormat

torch.set_num_threads(1)

W, H = 128, 64
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
# the CLI's low-delay settings at depth 4, which 128x64 divides into
# slices
LD = dict(rate_control="low_delay", transform_depth=4, intra_wavelet=1)
CASES = [("422", 10), ("420", 12), ("420", 8)]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _format(chroma, bit_depth):
    return video_format(W, H, getattr(ChromaFormat, "C" + chroma), bit_depth)


def _random_planes(chroma, bit_depth, seed):
    """Uniform samples over the whole range, the extremes in the first
    rows."""
    vs, hs = {"444": (0, 0), "422": (0, 1), "420": (1, 1)}[chroma]
    rng = np.random.default_rng(seed)
    top = (1 << bit_depth) - 1
    out = []
    for k in range(3):
        h, w = (H, W) if k == 0 else (H >> vs, W >> hs)
        p = rng.integers(0, top + 1, (h, w))
        p[0], p[1] = 0, top
        out.append(p.astype(np.uint8 if bit_depth == 8 else np.uint16))
    return out


@pytest.mark.parametrize("chroma,bit_depth", CASES)
def test_analysis_equals_the_plain_reference(chroma, bit_depth):
    ldref = _load("ldref")
    planes = _random_planes(chroma, bit_depth, 1000 + bit_depth)
    p = api.Encoder(_format(chroma, bit_depth), EncoderConfig(**LD),
                    device="cpu").params
    got = pipeline.make_lowdelay_analyze(p)(*pipeline.planes_to_device(
        planes, bit_depth, "cpu"))
    want = ldref.analyse(planes, bit_depth, chroma, LD["transform_depth"])
    got = list(got[:3]) + [a for agg in got[3:] for a in agg]
    want = list(want[:3]) + [a for agg in want[3:] for a in agg]
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.to(torch.int64), w)
    # every slice has nonzero coefficients at base 0, none at base 60
    assert (want[3][0] > 0).all() and (want[4][0] >= 0).all()


@pytest.mark.parametrize("chroma,bit_depth", CASES)
def test_standard_decoder_reads_the_ports_stream_as_the_port(chroma,
                                                             bit_depth):
    vc2spec = _load("vc2spec")
    frames = make_frames(3, W, H, chroma_format=getattr(
        ChromaFormat, "C" + chroma), bit_depth=bit_depth)
    stream = api.Encoder(_format(chroma, bit_depth), EncoderConfig(**LD),
                         device="cpu").encode_stream(frames)
    mine = api.Decoder(device="cpu").decode_stream(stream)
    spec = vc2spec.decode_stream(stream)
    assert [num for num, _ in spec] == [0, 1, 2]
    top = (1 << bit_depth) - 1
    for (_, want), got, src in zip(spec, mine, frames):
        for w, g, s in zip(want, got, src):
            assert np.array_equal(w.astype(np.int64), g.astype(np.int64))
            # near the source: the offset was taken off and added back
            err = np.abs(g.astype(np.int64) - s.astype(np.int64))
            assert float(err.mean()) < (top + 1) / 64


@pytest.mark.parametrize("helpers", [1, 3, 64])
@pytest.mark.parametrize("chroma,bit_depth", CASES)
def test_pooled_packing_gives_the_same_bytes(chroma, bit_depth, helpers,
                                             monkeypatch):
    """A picture's slices packed by rows on `helpers` pool threads (more
    than the pool has, at 64) equal the slices packed on the calling
    thread, at a size that packs inline by default."""
    planes = _random_planes(chroma, bit_depth, 3000 + bit_depth)
    p = api.Encoder(_format(chroma, bit_depth), EncoderConfig(**LD),
                    device="cpu").params
    host = loe.fetch_analysis(pipeline.make_lowdelay_analyze(p)(
        *pipeline.planes_to_device(planes, bit_depth, "cpu")))
    assert native.ld_pack_helpers(sum(a.size for a in host[:3])) == 0
    inline = loe.encode_picture_from_analysis(host, p, 0, False)
    real = native.ld_encode_tab
    monkeypatch.setattr(native, "ld_encode_tab", lambda *a, **k: real(
        *a, **dict(k, helpers=helpers)))
    assert loe.encode_picture_from_analysis(host, p, 0, False) == inline


@pytest.mark.parametrize("chroma,bit_depth", [("422", 10), ("420", 12)])
def test_deep_intra_picture_is_centred(chroma, bit_depth):
    vf = _format(chroma, bit_depth)
    grey = make_frames(1, W, H, chroma_format=vf.chroma_format,
                       bit_depth=bit_depth)[0]
    grey = tuple(np.full_like(pl, 1 << (bit_depth - 1)) for pl in grey)
    kw = dict(rate_control="lossless", gop_structure="intra_only")
    enc = api.Encoder(vf, EncoderConfig(**kw), device="cpu")
    band_bits = []
    ei_intra.encode_picture(grey, enc.params, 0, band_bits_out=band_bits,
                            device="cpu")
    assert not band_bits[0].any()
    src = _random_planes(chroma, bit_depth, 2000 + bit_depth)
    stream = enc.encode_stream([grey, tuple(src)])
    got = api.Decoder(device="cpu").decode_stream(stream)
    for g3, w3 in zip(got, [grey, src]):
        for g, w in zip(g3, w3):
            assert g.dtype == np.uint16 and np.array_equal(g, w)
