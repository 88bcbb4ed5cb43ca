"""The port's streaming push/pull decoder, telemetry overlay, leveled log
and stream tools against the JAX package's, on the CPU.

- `ParseSync`: the units of a stream pushed in small pieces equal
  `split_units`, and after garbage both machines resync to the same
  units.
- `StreamingDecoder`: the same stream pushed in the same seeded pieces
  gives the same (picture number, planes) pairs in both packages, with
  the same skipped pictures, MD5 failures and picture errors: a
  progressive biref stream in presentation and coded order, with
  `earliest_frame` and `skip_ratio`; an interlaced stream (its reorder
  buffer 4+1, no skipping); a progressive stream followed by the
  interlaced one (a mid-stream sequence-header change: the first
  sequence drains, and as the end of sequence leaves both decoders
  flushing, the second comes out in coded order); a corrupted MD5
  stream.
- `overlay_motion` on the same plane and motion dict, and a telemetry
  decode plane for plane (the MD5s checked on the clean pictures).
- `utils/log`: the JAX package's level and handler cases
  (`tests/test_telemetry.py`), and the level read from SCHRO_TPU_DEBUG.
- `dirac_inspect`, `dump_gop` and `drc_cut` print the JAX tools' text;
  `drc_cut` writes the JAX tool's bytes.

The streams come from the port's CPU encoder (fixed quantisers, 96x80),
so the JAX side compiles only its decoder.
"""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from schroedinger_tpu import bitstream as j_bs
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.decoder import overlay as j_overlay
from schroedinger_tpu.decoder import streaming as j_streaming
from schroedinger_tpu.utils import log as j_log
from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.decoder import overlay as t_overlay
from schroedinger_tpu_torch.decoder import streaming as t_streaming
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.slice_config import make_frames, video_format
from schroedinger_tpu_torch.tools import dirac_inspect, drc_cut, dump_gop
from schroedinger_tpu_torch.utils import log as t_log

torch.set_num_threads(1)

W, H = 96, 80
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _encode(frames, vf=None, **kw):
    enc = GopEncoder(vf or video_format(W, H), device="cpu",
                     base_qi_intra=12, base_qi_inter=16,
                     enable_scene_change=False, **kw)
    return enc.encode_stream(frames)


def _interlaced_vf():
    return dataclasses.replace(video_format(W, H), interlaced=True,
                               top_field_first=False, interlaced_coding=True)


@pytest.fixture(scope="module")
def streams():
    frames = make_frames(13, W, H)
    out = {
        "biref": _encode(frames[:9], gop_length=4, gop_structure="biref",
                         subgroup_length=3),
        "long_subgroups": _encode(frames, gop_length=13,
                                  gop_structure="biref", subgroup_length=4),
        "interlaced": _encode(frames[:5], _interlaced_vf(), gop_length=4,
                              gop_structure="biref", subgroup_length=3),
        "md5": _encode(frames[:5], gop_length=5, enable_md5=True),
    }
    out["header_change"] = (_encode(frames[:4], gop_length=4)
                            + out["interlaced"])
    bad = bytearray(out["md5"])
    bad[len(bad) // 2] ^= 0xFF
    out["corrupted"] = bytes(bad)
    return out


def _pull_units(ps, stream, pieces):
    got = []
    for piece in pieces(stream):
        ps.push(piece)
        while True:
            u = ps.pull_unit()
            if u is None:
                break
            got.append(u)
    return got


def _seeded_pieces(seed, hi=256):
    def pieces(stream):
        rng = np.random.default_rng(seed)
        i = 0
        while i < len(stream):
            n = int(rng.integers(1, hi + 1))
            yield stream[i:i + n]
            i += n
    return pieces


def test_parse_sync_units_match_split_units(streams):
    stream = streams["biref"]

    def pieces(s):
        return (s[i:i + 17] for i in range(0, len(s), 17))
    got = _pull_units(t_streaming.ParseSync(), stream, pieces)
    assert got == list(bs.split_units(stream))
    assert got == _pull_units(j_streaming.ParseSync(), stream, pieces)


@pytest.mark.parametrize("cut", [50, 777])
def test_parse_sync_resyncs_after_garbage(streams, cut):
    stream = streams["biref"]
    units = list(bs.split_units(stream))
    dirty = stream[:cut] + b"\xde\xad" * 40 + stream[len(stream) // 2:]
    pieces = _seeded_pieces(cut, hi=64)
    got = _pull_units(t_streaming.ParseSync(), dirty, pieces)
    assert got == _pull_units(j_streaming.ParseSync(), dirty, pieces)
    assert len([u for u in got if u in units]) >= 2
    assert got[-1][0] == bs.END_OF_SEQUENCE


def _drive(cls, stream, seed, coded_order=False, earliest=None, skip=None,
           **kw):
    dec = cls(coded_order=coded_order, **kw)
    if earliest is not None:
        dec.set_earliest_frame(earliest)
    if skip is not None:
        dec.set_skip_ratio(skip)
    out = []
    for piece in _seeded_pieces(seed)(stream):
        dec.push(piece)
        out += dec.pull_all()
    out += dec.pull_all()
    return dec, out


# name: (stream, coded order, earliest frame, skip ratio, expected numbers)
DRIVES = {
    "presentation": ("biref", False, None, None, list(range(9))),
    "coded_order": ("biref", True, None, None,
                    [0, 3, 1, 2, 4, 7, 5, 6, 8]),
    "earliest_frame": ("biref", False, 5, None, [0, 3, 4, 5, 6, 7, 8]),
    "skip_ratio": ("long_subgroups", False, None, 0.4, None),
    "interlaced": ("interlaced", False, None, None, list(range(10))),
    "interlaced_no_skip": ("interlaced", False, 5, 0.2, list(range(10))),
    "header_change": ("header_change", False, None, None,
                      list(range(4)) + [0, 3, 1, 2, 6, 4, 5, 8, 7, 9]),
    "md5": ("md5", False, None, None, list(range(5))),
    "corrupted": ("corrupted", False, None, None, None),
}


@pytest.mark.parametrize("name", sorted(DRIVES))
def test_streaming_decoder_matches_jax(streams, name):
    key, coded, earliest, skip, nums = DRIVES[name]
    stream = streams[key]
    port, got = _drive(t_streaming.StreamingDecoder, stream, 7, coded,
                       earliest, skip, device="cpu")
    jax, want = _drive(j_streaming.StreamingDecoder, stream, 7, coded,
                       earliest, skip)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a3), (_, b3) in zip(got, want):
        for a, b in zip(a3, b3):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, np.asarray(b))
    assert port.skipped == jax.skipped
    assert port.md5_failures == jax.md5_failures
    assert ([e["kind"] for e in port.errors]
            == [e["kind"] for e in jax.errors])
    assert port.eos_seen and jax.eos_seen
    if nums is not None:
        assert [n for n, _ in got] == nums
        assert port.md5_failures == [] and port.errors == []
    if name == "skip_ratio":
        assert port.skipped and all(
            n in [m for m, _ in got] for n in (0, 4, 8, 12))
    if name == "header_change":
        shapes = [p[0].shape for _, p in got]
        assert shapes == [(H, W)] * 4 + [(H // 2, W)] * 10
    if name == "corrupted":
        assert port.md5_failures or port.errors


@pytest.fixture(scope="module")
def inter_picture(streams):
    """The planes and motion dict of the biref stream's first B picture,
    from the port's decoder."""
    dec = t_core.StreamDecoder(device="cpu")
    for code, payload in bs.split_units(streams["biref"]):
        if code == bs.SEQUENCE_HEADER:
            dec.vf = bs.read_sequence_header(
                bs.BitReader(payload)).video_format
        elif bs.is_picture(code):
            if bs.num_refs(code) == 2:
                parsed = dec._parse_picture(code, payload)
                num, planes = dec.decode_picture_unit(code, payload)
                return planes[0].numpy(), parsed[7], parsed[1]
            dec.decode_picture_unit(code, payload)
    raise AssertionError("no B picture")


@pytest.mark.parametrize("variant", ["decoded", "intra_blocks",
                                     "no_split"])
def test_overlay_motion_equals_jax(inter_picture, variant):
    y, mv, p = inter_picture
    mv = {k: np.array(v) for k, v in mv.items()}
    if variant == "intra_blocks":
        mv["pred_mode"][::2, 1::3] = 0
        mv["dx1"][1::2] = -37
    elif variant == "no_split":
        mv.pop("split", None)
    got = t_overlay.overlay_motion(y, mv, p)
    assert np.array_equal(got, j_overlay.overlay_motion(y, mv, p))
    assert not np.array_equal(got, y)
    assert np.array_equal(y, inter_picture[0])     # drawn on a copy


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_telemetry_decode_equals_jax(streams, monkeypatch, how):
    stream = streams["md5"]
    if how == "environment":
        monkeypatch.setenv("SCHRO_TPU_TELEMETRY", "1")
        port, jax = t_core.StreamDecoder(device="cpu"), j_core.StreamDecoder()
    else:
        monkeypatch.setenv("SCHRO_TPU_TELEMETRY", "0")
        assert not t_core.StreamDecoder(device="cpu").telemetry
        port = t_core.StreamDecoder(telemetry=True, device="cpu")
        jax = j_core.StreamDecoder(telemetry=True)
    assert port.telemetry and jax.telemetry
    got, want = port.decode_stream(stream), jax.decode_stream(stream)
    clean = t_core.StreamDecoder(telemetry=False,
                                 device="cpu").decode_stream(stream)
    assert len(got) == len(want) == 5
    assert port.md5_failures == jax.md5_failures == []
    for a3, b3, c3 in zip(got, want, clean):
        for a, b in zip(a3, b3):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert any(not np.array_equal(a3[0], c3[0]) for a3, c3 in
               zip(got, clean))


def _log_cases(log):
    seen = []
    log.set_log_handler(lambda lvl, tag, msg: seen.append((lvl, tag, msg)))
    old = log.get_level()
    try:
        log.set_level(log.WARNING)
        log.error("t", "boom %d", 1)
        log.warning("t", "warn")
        log.info("t", "hidden")
        log.debug("t", "hidden")
        assert seen == [(log.ERROR, "t", "boom 1"),
                        (log.WARNING, "t", "warn")]
        log.set_level(log.DEBUG)
        log.debug("t", "now visible")
        log.log("t", "still hidden")
        log.set_level(log.LOG)
        log.log("t", "%s and %s", "a", "b")
    finally:
        log.set_log_handler(None)
        log.set_level(old)
    return seen


def test_log_levels_and_handler_equal_jax(capsys):
    assert _log_cases(t_log) == _log_cases(j_log)
    assert (t_log.NONE, t_log.ERROR, t_log.LOG) == (j_log.NONE, j_log.ERROR,
                                                     j_log.LOG)
    old = t_log.get_level()
    try:
        t_log.set_level(t_log.INFO)
        t_log.info("tag", "to %s", "stderr")
        assert capsys.readouterr().err == "SCHRO-TPU INFO: tag: to stderr\n"
    finally:
        t_log.set_level(old)


@pytest.mark.parametrize("raw", ["", "3", "info", "DEBUG", "9", "-2",
                                 "bogus"])
def test_log_level_from_environment_equals_jax(monkeypatch, raw):
    monkeypatch.setenv("SCHRO_TPU_DEBUG", raw)
    assert t_log._env_level() == j_log._env_level()


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stream_file(streams, tmp_path_factory):
    path = tmp_path_factory.mktemp("tools") / "in.drc"
    path.write_bytes(streams["interlaced"])
    return str(path)


def _run_jax_tool(name, argv, monkeypatch, capsys):
    mod = _jax_tool(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["-v"]], ids=["plain", "verbose"])
def test_dirac_inspect_prints_the_jax_text(stream_file, monkeypatch, capsys,
                                           argv):
    want = _run_jax_tool("dirac_inspect", [stream_file] + argv,
                         monkeypatch, capsys)
    dirac_inspect.main([stream_file] + argv)
    got = capsys.readouterr().out
    assert got == want and "sequence_header" in got
    if argv:
        assert "picture 9 refs" in got and "wavelet" in got


def test_dump_gop_prints_the_jax_text(stream_file, monkeypatch, capsys):
    want = _run_jax_tool("dump_gop", [stream_file], monkeypatch, capsys)
    dump_gop.main([stream_file])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 10


@pytest.mark.parametrize("start,count", [(0, None), (3, 4), (6, 2)])
def test_drc_cut_writes_the_jax_bytes(stream_file, monkeypatch, capsys,
                                      tmp_path, start, count):
    args = ["--start", str(start)] + ([] if count is None
                                      else ["--count", str(count)])
    j_out, t_out = str(tmp_path / "j.drc"), str(tmp_path / "t.drc")
    want = _run_jax_tool("drc_cut", [stream_file, j_out] + args,
                         monkeypatch, capsys)
    drc_cut.main([stream_file, t_out] + args)
    assert capsys.readouterr().out == want
    cut = open(t_out, "rb").read()
    assert cut == open(j_out, "rb").read()
    assert list(bs.split_units(cut)) == list(j_bs.split_units(cut))
