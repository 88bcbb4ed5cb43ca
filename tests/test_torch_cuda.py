"""Card-only checks of the port (marked `cuda`; they skip without a GPU).

The ME search CUDA kernel (every shape and mode the ME launches, one
picture and a batch) and its cost probe against the plain PyTorch
version, small streams of the slices encoded on the card against the CPU
encode (every long-GOP rate control among them), the multiquant sums'
float32 order on the card against the CPU, the pipelined decoder against
the per-picture one, interlaced streams and the telemetry overlay on the
card against the CPU, the entry points' default device, and the multi-
device paths on worlds of ranks that share the card (frames-within-GOP,
tiles) and on shard threads (GOP sharding).  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from schroedinger_tpu_torch import api
from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.decoder.pipeline import PipelinedStreamDecoder
from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.slice_config import (CONFIG, CONFIG_BENCH,
                                                 CONFIG_FLAGSHIP,
                                                 make_frames, video_format)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(rad, bs, flat, dev, nby=5, nbx=7, bound=24, scale=1,
          parent=None, seed=0):
    """me_search's arguments from a numpy seed: u8 planes (flat: every
    candidate ties), a field at the grid's own size (scale 1) or at a
    parent's (hy, hx) = `parent`, hints running past the contract."""
    margin = bound + 2 * rad + 16
    rng = np.random.default_rng(7 * rad + bs + 100 * flat + scale
                                + 1000 * seed)
    if flat:
        cur = np.full((nby * bs, nbx * bs), 77, np.uint8)
        ref = np.full((nby * bs, nbx * bs), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
        ref = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    hy, hx = parent or (nby, nbx)
    # hints run past the contract (|hint| <= margin - rad) and past the
    # clamp: the hint clamp and the window clamp must agree
    lim = (margin + 8) // max(scale, 1) + 8
    field = rng.integers(-lim, lim + 1, (hy, hx, 2)).astype(np.int32)
    return (torch.tensor(cur, device=dev), torch.tensor(ref, device=dev),
            None if scale == 0 else torch.tensor(field, device=dev), scale,
            bs, bs, rad, margin + 8, margin)


def _assert_kernel_equals_plain(args):
    before = pr.LAUNCHES
    got = pr.me_search(*args)
    assert pr.LAUNCHES == before + 1
    want = pr.me_search_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("rad,bs", [(2, 4), (2, 8), (2, 16), (1, 16),
                                    (8, 4), (0, 16)])
def test_patch_refine_kernel_matches_plain(cuda_device, rad, bs, flat):
    """me_search's kernel == its plain version, hints given at the grid's
    own size; (1, 16) takes the generic instance."""
    args = _case(rad, bs, flat, cuda_device)
    mv, _ = _assert_kernel_equals_plain(args)
    if flat:                                    # the first candidate wins
        assert torch.equal(mv, args[2].clamp(-args[7], args[7]) - rad)


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("mode", ["coarse", "refine-4", "refine-8",
                                  "refine-16", "zero", "generic-12",
                                  "generic-6"])
def test_me_search_modes_kernel_matches_plain(cuda_device, mode, flat):
    """The ME's launches: the coarse scan (scale 0, radius 8), the refine
    from a parent grid (scale 2) at each block size, the zero SAD, and a
    block size no instance is specialised for."""
    args = {"coarse": dict(rad=8, bs=4, scale=0),
            "refine-4": dict(rad=2, bs=4, scale=2, parent=(3, 4)),
            "refine-8": dict(rad=2, bs=8, scale=2, parent=(5, 7)),
            "refine-16": dict(rad=2, bs=16, scale=2, parent=(5, 7)),
            "zero": dict(rad=0, bs=16, scale=0),
            "generic-12": dict(rad=3, bs=12, scale=2, parent=(3, 4)),
            "generic-6": dict(rad=1, bs=6, scale=2, parent=(3, 4))}[mode]
    _assert_kernel_equals_plain(_case(flat=flat, dev=cuda_device, **args))


_MODES = {"coarse": dict(rad=8, bs=4, scale=0),
          "refine-4": dict(rad=2, bs=4, scale=2, parent=(3, 4)),
          "refine-8": dict(rad=2, bs=8, scale=2, parent=(5, 7)),
          "refine-16": dict(rad=2, bs=16, scale=2, parent=(5, 7)),
          "median": dict(rad=0, bs=16, scale=1),
          "zero": dict(rad=0, bs=16, scale=0),
          "generic-12": dict(rad=3, bs=12, scale=2, parent=(3, 4))}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_me_search_batch_kernel_matches_plain(cuda_device, mode):
    """Three current planes against one reference (the B pictures of a
    subgroup): one launch for the batch, equal to the plain version and to
    three single-picture launches."""
    cases = [_case(flat=False, dev=cuda_device, seed=k, **_MODES[mode])
             for k in range(3)]
    args = list(cases[0])
    args[0] = torch.stack([c[0] for c in cases])
    if args[2] is not None:
        args[2] = torch.stack([c[2] for c in cases])
    got = _assert_kernel_equals_plain(args)
    assert got[0].shape[0] == 3 and got[1].shape[0] == 3
    for k in range(3):
        one = list(args)
        one[0] = args[0][k].clone()      # 16-byte aligned, as me_search
        one[2] = None if args[2] is None else args[2][k].clone()
        for g, w in zip(got, pr.me_search(*one)):
            assert torch.equal(g[k], w)


@pytest.mark.cuda
def test_patch_refine_rejects_bad_inputs(cuda_device):
    args = list(_case(2, 8, False, cuda_device))
    bad_dtype = list(args)
    bad_dtype[1] = args[1].to(torch.int32)          # ref must be u8
    with pytest.raises(TypeError):
        pr.me_search(*bad_dtype)
    bad_layout = list(args)
    bad_layout[2] = args[2].transpose(0, 1)         # field not contiguous
    with pytest.raises(ValueError):
        pr.me_search(*bad_layout)
    bad_grid = list(args)
    bad_grid[0] = args[0][:, 1:].contiguous()       # not whole blocks
    bad_grid[1] = args[1][:, 1:].contiguous()
    with pytest.raises(ValueError):
        pr.me_search(*bad_grid)
    bad_align = list(args)
    buf = torch.zeros(args[0].numel() + 16, dtype=torch.uint8,
                      device=cuda_device)
    bad_align[0] = buf[8:8 + args[0].numel()].view(args[0].shape)
    with pytest.raises(ValueError):                 # not 16-byte aligned
        pr.me_search(*bad_align)


@pytest.mark.cuda
def test_small_stream_on_card_equals_cpu(cuda_device):
    frames = make_frames(4, 128, 64)
    vf = video_format(128, 64)
    before = pr.LAUNCHES
    s_gpu = GopEncoder(vf, device=cuda_device,
                       **CONFIG).encode_stream(frames)
    assert pr.LAUNCHES > before
    s_cpu = GopEncoder(vf, device="cpu", **CONFIG).encode_stream(frames)
    assert s_gpu == s_cpu
    dec = StreamDecoder(device=cuda_device)
    out = dec.decode_stream(s_gpu)
    assert len(out) == 4 and dec.md5_failures == [] and dec.errors == []


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [4, 16])
def test_probe_full_variant_matches_plain(cuda_device, bs):
    """Of the probe's four variants only `full` computes the search: it
    equals the plain version; the others launch and are counted."""
    args = _case(2, bs, False, cuda_device, scale=2, parent=(3, 4))
    before = pr.PROBE_LAUNCHES
    got = pr.me_search_probe("full", *args)
    want = pr.me_search_plain(*args)
    for variant in pr.PROBE_VARIANTS[1:]:
        outs = pr.me_search_probe(variant, *args)
        assert all(o.shape == w.shape for o, w in zip(outs, want))
    torch.cuda.synchronize()
    assert pr.PROBE_LAUNCHES == before + 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        pr.me_search_probe("nowindow", *args)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,rate,level,launches,binds", [
    (128, 64, 500_000, 0, 5 * (1 + 2 * 7), False),
    (320, 192, 100_000, 150_000, None, True)],
    ids=["full-reservoir", "binding-fit"])
def test_small_flagship_stream_on_card_within_bands_of_cpu(
        cuda_device, w, h, rate, level, launches, binds):
    """The biref CBR slice at a small size: float sums differ between the
    card and the CPU, so the streams are held in bands (luma PSNR within
    0.7 dB, bytes within 15 %), not bytes; both decode with every MD5
    matching, and two-reference pictures launch the kernel twice as often
    as one-reference ones.  With a half-empty reservoir at a rate the
    content cannot meet, the 22-step lambda fit binds on the card as on
    the CPU."""
    frames = make_frames(9, w, h)
    vf = video_format(w, h)
    cfg = dict(CONFIG_FLAGSHIP, bitrate=rate, buffer_level=level)
    before = pr.LAUNCHES
    e_gpu = GopEncoder(vf, **cfg)                            # device=None
    s_gpu = e_gpu.encode_stream(frames)
    # I, one-reference P, 3 B, two-reference P, 3 B; 128x64 has a
    # 3-level pyramid, so levels + 2 = 5 searches per reference
    assert pr.LAUNCHES > before
    if launches is not None:
        assert pr.LAUNCHES - before == launches
    e_cpu = GopEncoder(vf, device="cpu", **cfg)
    s_cpu = e_cpu.encode_stream(frames)
    for enc in (e_gpu, e_cpu):
        scales = [f["lam_scale"] for f in enc.stats.frames
                  if not f["intra"]]
        assert len(scales) == 8
        assert any(s < 0.99 for s in scales) == binds, scales
    psnrs = []
    for stream, device in ((s_gpu, None), (s_cpu, "cpu")):
        dec = StreamDecoder(device=device)
        out = dec.decode_stream(stream)
        assert len(out) == 9 and dec.md5_failures == [] and dec.errors == []
        psnrs.append(np.mean([_psnr(o[0], f[0])
                              for o, f in zip(out, frames)]))
    assert abs(psnrs[0] - psnrs[1]) < 0.7
    assert abs(len(s_gpu) - len(s_cpu)) < 0.15 * len(s_cpu)


@pytest.mark.cuda
def test_small_b_batch_stream_on_card_within_bands_of_cpu(cuda_device):
    """bench.py's configuration (MD5 off, B pictures batched) at 128x64:
    each batch of three B pictures launches each search once per
    reference; the card's stream is within the bands of the CPU's and the
    pipelined decoder gives the per-picture decoder's planes on the
    card."""
    frames = make_frames(9, 128, 64)
    vf = video_format(128, 64)
    cfg = dict(CONFIG_BENCH, bitrate=500_000)
    before = pr.LAUNCHES
    s_gpu = GopEncoder(vf, **cfg).encode_stream(frames)
    # I, one-reference P, a batch of 3 B, two-reference P, a batch of 3 B;
    # 5 searches per reference at 128x64
    assert pr.LAUNCHES - before == 5 * (1 + 2 + 2 + 2)
    s_cpu = GopEncoder(vf, device="cpu", **cfg).encode_stream(frames)
    psnrs = []
    for stream, device in ((s_gpu, None), (s_cpu, "cpu")):
        out = StreamDecoder(device=device).decode_stream(stream)
        dec = PipelinedStreamDecoder(device=device)
        piped = dec.decode_stream(stream)
        assert len(out) == 9 and dec.errors == []
        for a, b in zip(out, piped):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        psnrs.append(np.mean([_psnr(o[0], f[0])
                              for o, f in zip(out, frames)]))
    assert abs(psnrs[0] - psnrs[1]) < 0.7
    assert abs(len(s_gpu) - len(s_cpu)) < 0.15 * len(s_cpu)


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    enc = GopEncoder(video_format(128, 64), **CONFIG)
    dec = StreamDecoder()
    assert enc.device.type == "cuda" and dec.device.type == "cuda"
    assert PipelinedStreamDecoder().device.type == "cuda"
    assert api.Encoder(video_format(128, 64)).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 16, 17, 100, 544])
def test_multiquant_integral_image_same_bits_on_card(cuda_device, n):
    """The multiquant codeblock sums are float32 adds in the JAX
    package's order (`inter._block_cumsum0`): the card gives the CPU's
    bits (torch.equal), for scans shorter and longer than a block."""
    from schroedinger_tpu_torch.encoder import inter
    rng = np.random.default_rng(n)
    a = (rng.random((3, n, 37)) * rng.choice([1.0, 1e3, 1e6], (3, n, 37))
         ).astype(np.float32)
    cpu = inter._block_cumsum0(torch.tensor(a))
    card = inter._block_cumsum0(torch.tensor(a, device=cuda_device))
    assert torch.equal(card.cpu(), cpu)
    ys = np.asarray([n * k // 4 for k in range(5)])
    xs = np.asarray([37 * k // 6 for k in range(7)])
    sums = [inter._cb_sums(torch.tensor(a, device=d), torch.tensor(ys,
            device=d), torch.tensor(xs, device=d)).cpu()
            for d in ("cpu", cuda_device)]
    assert sums[0].shape == (3, 4, 6) and torch.equal(*sums)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(gop_structure="backref"),
    dict(gop_structure="backref", rate_control="constant_bitrate",
         bitrate=500_000, enable_rdo_cbr=False),
    dict(rate_control="constant_error"),
    dict(enable_multiquant=True)],
    ids=["backref_quality", "backref_alloc", "constant_error",
         "multiquant"])
def test_rate_control_stream_on_card_within_bands_of_cpu(cuda_device, kw):
    """Each long-GOP rate control at 128x64 (I, P, B pictures): the card's
    stream within the bands of the CPU's (0.7 dB, 15 %), decoded clean by
    the pipelined decoder on the card."""
    from schroedinger_tpu_torch.config import EncoderConfig
    frames = make_frames(5, 128, 64)
    vf = video_format(128, 64)
    streams = [api.Encoder(vf, EncoderConfig(**kw), device=d).encode_stream(
        frames) for d in (None, "cpu")]
    psnrs = []
    for stream, device in zip(streams, (None, "cpu")):
        dec = api.Decoder(device=device)
        out = dec.decode_stream(stream)
        assert len(out) == 5 and dec.errors == []
        psnrs.append(np.mean([_psnr(o[0], f[0])
                              for o, f in zip(out, frames)]))
    assert abs(psnrs[0] - psnrs[1]) < 0.7
    assert abs(len(streams[0]) - len(streams[1])) < 0.15 * len(streams[1])


# the launch shapes the long-GOP settings add (block size, estimation
# switches, phase correlation's rescan, chroma ME), all on the kernel's
# generic instance
_SETTING_SHAPES = {
    "medium-level0": dict(rad=2, bs=12, scale=2, parent=(3, 4)),
    "medium-level1": dict(rad=2, bs=6, scale=2, parent=(3, 4)),
    "no-hierarchical": dict(rad=8, bs=16, scale=0),
    "fullscan": dict(rad=32, bs=16, scale=0),
    "rescan": dict(rad=1, bs=16, scale=1),
    "chroma-8": dict(rad=0, bs=8, scale=1),
    "chroma-6": dict(rad=0, bs=6, scale=1),
    "chroma-4": dict(rad=0, bs=4, scale=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("mode", sorted(_SETTING_SHAPES))
def test_me_search_setting_shapes_kernel_matches_plain(cuda_device, mode,
                                                       flat):
    _assert_kernel_equals_plain(_case(flat=flat, dev=cuda_device,
                                      **_SETTING_SHAPES[mode]))


@pytest.mark.cuda
@pytest.mark.parametrize("gm", [None, (8, -4, 0, 0, 0, 0, 0, 0, 0, 0),
                                (3, -2, 16, 66000, -1200, 900, 64000, 0, 0,
                                 0)], ids=["mv300", "pan", "affine"])
def test_gather_render_card_equals_cpu(cuda_device, gm):
    """The per-pixel gather render on the card gives the CPU's planes
    (integer arithmetic throughout), vectors of 300 pel included."""
    from schroedinger_tpu_torch.ops import obmc
    from schroedinger_tpu_torch.params import GlobalMotion, Params
    p = Params(video_format=video_format(160, 96), num_refs=2,
               transform_depth=3)
    p.xblen_luma = p.yblen_luma = 24
    p.xbsep_luma = p.ybsep_luma = 8
    p.mv_precision = 2
    if gm is not None:
        p.have_global_motion = True
        p.global_motion = (GlobalMotion(*gm), GlobalMotion(*gm))
    rng = np.random.default_rng(1)
    yb, xb = p.y_num_blocks, p.x_num_blocks
    mv = {k: rng.integers(-1200, 1200, (yb, xb)).astype(np.int32)
          for k in ("dx1", "dy1", "dx2", "dy2")}
    mv.update({k: rng.integers(-128, 128, (yb, xb)).astype(np.int32)
               for k in ("dc0", "dc1", "dc2")})
    mv["pred_mode"] = rng.integers(0, 4, (yb, xb)).astype(np.int32)
    mv["using_global"] = rng.integers(0, 2, (yb, xb)).astype(np.int32)
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((96, 160), (48, 80), (48, 80))] * 2
    out = []
    for dev in ("cpu", cuda_device):
        ups = [obmc.make_halfpel(obmc.upsample_plane(torch.tensor(
            pl, device=dev))) for pl in planes]
        body = obmc.make_render_body(p, 2, use_patches=False)
        out.append(body({k: torch.tensor(v, device=dev)
                         for k, v in mv.items()}, ups[:3], ups[3:]))
    for a, b in zip(*out):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(motion_block_size="small", motion_block_overlap="full"),
    dict(motion_block_size="medium", codeblock_size="small"),
    dict(enable_chroma_me=1), dict(enable_hierarchical_estimation=0),
    dict(enable_deep_estimation=0, mv_precision=2),
    dict(enable_fullscan_estimation=1),
    dict(enable_phasecorr_estimation=1),
    dict(filtering="gaussian", enable_psnr=1, enable_ssim=1)],
    ids=["small_full", "medium_cb_small", "chroma_me", "no_hierarchical",
         "no_deep", "fullscan", "phasecorr", "gaussian_metrics"])
def test_setting_stream_on_card_within_bands_of_cpu(cuda_device, kw):
    """Each long-GOP setting of phases 19-22 at 128x64 (I, P and B
    pictures): the card's stream within the bands of the CPU's (0.7 dB,
    15 %; phase correlation runs cuFFT there), decoded clean by both
    decoders on the card to equal planes."""
    from schroedinger_tpu_torch.config import EncoderConfig
    frames = make_frames(5, 128, 64)
    vf = video_format(128, 64)
    streams = [api.Encoder(vf, EncoderConfig(**kw), device=d).encode_stream(
        frames) for d in (None, "cpu")]
    psnrs = []
    for stream, device in zip(streams, (None, "cpu")):
        dec = api.Decoder(device=device)
        out = dec.decode_stream(stream)
        assert len(out) == 5 and dec.errors == []
        base = StreamDecoder(device=device).decode_stream(stream)
        for a, b in zip(out, base):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        psnrs.append(np.mean([_psnr(o[0], f[0])
                              for o, f in zip(out, frames)]))
    assert abs(psnrs[0] - psnrs[1]) < 0.7
    assert abs(len(streams[0]) - len(streams[1])) < 0.15 * len(streams[1])


def _interlaced(vf, tff):
    import dataclasses
    return dataclasses.replace(vf, interlaced=True, top_field_first=tff)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,tff", [
    (dict(rate_control="constant_bitrate", bitrate=500_000,
          interlaced_coding=1, mv_precision=2), True),
    (dict(gop_structure="backref", interlaced_coding=1), False)],
    ids=["biref_cbr_tff", "backref_bff"])
def test_interlaced_stream_on_card_equals_cpu(cuda_device, kw, tff):
    """Field coding at 128x64 (128x32 fields; I, P and B fields): the
    card's stream equals the CPU's byte for byte, and the card's woven
    decode equals the CPU's."""
    from schroedinger_tpu_torch.config import EncoderConfig
    frames = make_frames(4, 128, 64)
    streams = [api.Encoder(_interlaced(video_format(128, 64), tff),
                           EncoderConfig(**kw), device=d).encode_stream(frames)
               for d in (None, "cpu")]
    assert streams[0] == streams[1]
    outs = [api.Decoder(device=d).decode_stream(streams[0])
            for d in (None, "cpu")]
    assert len(outs[0]) == 4 and outs[0][0][0].shape == (64, 128)
    for a, b in zip(*outs):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_telemetry_decode_on_card_equals_cpu(cuda_device):
    """The telemetry overlay on the card's decode (both decoders) equals
    the CPU's plane for plane; the MD5s hold."""
    frames = make_frames(5, 128, 64)
    stream = GopEncoder(video_format(128, 64), device="cpu",
                        **dict(CONFIG_FLAGSHIP, bitrate=500_000)
                        ).encode_stream(frames)
    want = StreamDecoder(telemetry=True, device="cpu").decode_stream(stream)
    for dec in (StreamDecoder(telemetry=True),
                PipelinedStreamDecoder(telemetry=True)):
        got = dec.decode_stream(stream)
        assert dec.md5_failures == [] and dec.errors == []
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_frames_in_gop_world_on_card(cuda_device):
    """Graft-entry stage 1 over two ranks sharing the card (gloo): each
    rank's B picture equals rank 0's batched step, and every N = 1 step
    launches kernel #1 as often as the batch."""
    from schroedinger_tpu_torch import graft_entry
    r = graft_entry.dryrun_multichip(2, stages=(1,))[1]
    assert r["batch_launches"] > 0
    assert r["launches"] == [r["batch_launches"]] * 2
    assert r["batch_ms"] > 0 and r["single_ms"] > 0


@pytest.mark.cuda
def test_tiles_world_on_card(cuda_device):
    """Graft-entry stage 2 over two ranks on the card: the row-sharded
    wavelet, upsample and banded render equal the unsharded ops."""
    from schroedinger_tpu_torch import graft_entry
    graft_entry.dryrun_multichip(2, stages=(2,))


@pytest.mark.cuda
def test_gop_sharding_on_card(cuda_device):
    """128x64 on the card: two shard threads give the serial stream
    (fixed quantisers, scene change off), and bench.py's configuration
    with per-chunk reservoirs gives the sequential shards' stream."""
    from schroedinger_tpu_torch.parallel import gops
    frames = make_frames(8, 128, 64)
    vf = video_format(128, 64)

    def exact():
        return GopEncoder(vf, gop_length=4, enable_scene_change=False,
                          **CONFIG)

    def bench():
        return GopEncoder(vf, **dict(CONFIG_BENCH, gop_length=4))
    assert (gops.encode_gops_sharded(frames, exact, n_shards=2)
            == exact().encode_stream(frames))
    assert (gops.encode_gops_sharded(frames, bench, n_shards=2, exact=False)
            == gops.encode_gops_sharded(frames, bench, n_shards=2,
                                        sequential=True, exact=False))
