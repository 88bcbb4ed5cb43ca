"""The port's whole slice against the JAX package on the CPU: the
fixed-quantiser backref long-GOP encode (I P P P, quarter-pel ME, MD5
aux units) and the decode of its stream, at 128x64.

  (a) the port's stream is byte-identical to the JAX encoder's;
  (b) the JAX decoder decodes the port's stream with no MD5 failure;
  (c) the port's decoder decodes the JAX stream to the JAX decoder's
      planes;
  (d) importing and running the port leaves jax unimported;
  (e) reference state carried across with convert.py seeds the port's
      inter step to the JAX step's exact output.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.decoder import intra as j_dintra
from schroedinger_tpu.encoder import gop as j_gop
from schroedinger_tpu.encoder import inter as j_inter
from schroedinger_tpu.encoder import intra as j_intra
from schroedinger_tpu_torch import convert
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.decoder import intra as t_dintra
from schroedinger_tpu_torch.encoder import gop as t_gop
from schroedinger_tpu_torch.encoder import inter as t_inter
from schroedinger_tpu_torch.encoder import intra as t_intra
from schroedinger_tpu_torch.slice_config import (CONFIG, make_frames,
                                                 video_format)

torch.set_num_threads(1)

W, H = 128, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frames():
    return make_frames(4, W, H)


@pytest.fixture(scope="module")
def port_stream(frames):
    return t_gop.GopEncoder(video_format(W, H), device="cpu", **CONFIG).encode_stream(
        frames)


@pytest.fixture(scope="module")
def jax_stream(frames):
    return j_gop.GopEncoder(video_format(W, H), **CONFIG).encode_stream(frames)


def _picture_kinds(stream):
    from schroedinger_tpu import bitstream as bs
    return ["I" if bs.num_refs(c) == 0 else "P"
            for c, _ in bs.split_units(stream) if bs.is_picture(c)]


def test_a_port_stream_is_byte_identical(port_stream, jax_stream):
    assert _picture_kinds(port_stream) == ["I", "P", "P", "P"]
    assert len(port_stream) == len(jax_stream)
    assert port_stream == jax_stream


def test_b_jax_decoder_accepts_port_stream(port_stream, frames):
    dec = j_core.StreamDecoder()
    out = dec.decode_stream(port_stream)
    assert dec.md5_failures == [] and dec.errors == []
    assert len(out) == len(frames)
    for (y, _, _), (y0, _, _) in zip(out, frames):
        mse = np.mean((y.astype(np.float64) - y0) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30


def test_c_port_decoder_matches_jax_decoder(jax_stream):
    jdec = j_core.StreamDecoder()
    want = jdec.decode_stream(jax_stream)
    tdec = t_core.StreamDecoder(device="cpu")
    got = tdec.decode_stream(jax_stream)
    assert tdec.md5_failures == [] and tdec.errors == []
    assert len(got) == len(want) == 4
    for n, (g3, w3) in enumerate(zip(got, want)):
        for g, w, name in zip(g3, w3, "yuv"):
            np.testing.assert_array_equal(g, w, err_msg=f"{n} {name}")


def test_d_port_runs_without_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from schroedinger_tpu_torch.decoder.core import StreamDecoder
        from schroedinger_tpu_torch.encoder.gop import GopEncoder
        from schroedinger_tpu_torch.slice_config import (CONFIG, make_frames,
                                                         video_format)
        frames = make_frames(3, 64, 64)
        s = GopEncoder(video_format(64, 64), device="cpu",
                       **CONFIG).encode_stream(frames)
        d = StreamDecoder(device="cpu")
        out = d.decode_stream(s)
        assert len(out) == 3 and d.md5_failures == [] and d.errors == []
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        print("NOJAX-OK")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX-OK" in res.stdout


def test_e_convert_roundtrip_seeds_inter_step(frames):
    """A JAX RefFrame (planes + half-pel planes) crosses into the port
    through convert.py and seeds its P step: the parse unit and the
    reconstruction equal the JAX step's."""
    enc = j_gop.GopEncoder(video_format(W, H), **CONFIG)
    p_i = enc._params(0)
    _unit, jrecon = j_intra.encode_picture(frames[0], p_i, 0,
                                           quant_indices=12, is_ref=True,
                                           return_recon=True)
    jref = j_core.RefFrame(tuple(np.asarray(pl) for pl in jrecon))
    jups = [np.asarray(u) for u in jref.get_upsampled()]
    tref = convert.ref_frame_from_numpy(jref.planes, jups, device="cpu")
    planes, ups = convert.ref_frame_to_numpy(tref)
    for a, b in zip(planes + tuple(ups), jref.planes + tuple(jups)):
        np.testing.assert_array_equal(a, b)
    # the port recomputes the same half-pel planes when none are given
    fresh = convert.ref_frame_from_numpy(jref.planes, device="cpu")
    for a, b in zip(fresh.get_upsampled(), jups):
        np.testing.assert_array_equal(a.numpy(), b)

    p = enc._params(1)
    ju, jrec, *_ = j_inter.encode_inter_picture(frames[1], p, 1, 0, jref,
                                                base_qi=20, retired=0)
    tu, trec, *_ = t_inter.encode_inter_picture(frames[1], p, 1, 0, tref,
                                                base_qi=20, retired=0)
    assert tu == ju
    for a, b in zip(trec, jrec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_intra_picture_parity(frames):
    """Intra encode (bytes + decoder-exact recon) and decode."""
    p = j_gop.GopEncoder(video_format(W, H), **CONFIG)._params(0)
    ju, jrec = j_intra.encode_picture(frames[2], p, 2, quant_indices=16,
                                      is_ref=True, retired=0,
                                      return_recon=True)
    tu, trec = t_intra.encode_picture(frames[2], p, 2, quant_indices=16,
                                      is_ref=True, retired=0,
                                      return_recon=True, device="cpu")
    assert tu == ju
    for a, b in zip(trec, jrec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # transform data starts after parse info (13) + header + params
    from schroedinger_tpu.coding.bitio import BitReader
    from schroedinger_tpu import bitstream as bs
    from schroedinger_tpu.params import Params
    payload = ju[13:]
    r = BitReader(payload)
    r.read_bits(32)
    r.read_sint()
    r.sync()
    q = Params(video_format=video_format(W, H), num_refs=0)
    bs.read_transform_parameters(r, q)
    r.sync()
    data = payload[r.bits_read // 8:]
    jdec = j_dintra.decode_picture(data, q)
    tdec = t_dintra.decode_picture(data, q, device="cpu")
    for a, b, c in zip(tdec, jdec, trec):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


def test_encode_frame_path_matches_jax(frames):
    """The unpipelined per-frame path (encode_frame -> _encode_ref, with
    the intra-bailout check) gives the JAX encoder's units."""
    tenc = t_gop.GopEncoder(video_format(W, H), device="cpu", **CONFIG)
    jenc = j_gop.GopEncoder(video_format(W, H), **CONFIG)
    for planes in frames[:3]:
        assert tenc.encode_frame(planes) == jenc.encode_frame(planes)
    assert tenc.flush() == jenc.flush() == b""


def test_unported_options_raise():
    for kw in (dict(gop_structure="biref"), dict(bitrate=8_000_000),
               dict(quantiser_engine=object())):
        with pytest.raises(NotImplementedError):
            t_gop.GopEncoder(video_format(W, H), **kw)
    # options whose non-default branches are not ported are not taken
    for kw in (dict(block_size="small"), dict(codeblock_size="full"),
               dict(enable_multiquant=True), dict(downsample_levels=3)):
        with pytest.raises(TypeError):
            t_gop.GopEncoder(video_format(W, H), **kw)
