"""What decides `correct`: the streams coded in the window, judged against
the source frames the benchmark made, after the window has closed.  The
configuration names its check (`"check"`, `CHECKS`; "longgop" where it
names none).

The long-GOP check (`check_encode`).  Every stream's headers are read
(`refcodec`'s parser) and its size taken;
a sample of the streams, drawn from the seed, is decoded whole by the
reference decoder (`refcodec`, a frozen copy of the port's Dirac decoder
that imports nothing of the program) and judged by what it says:

- `lost`: frames of a sampled stream that did not decode, or are not
  there; `misnumbered`: pictures under a number that is not their frame's
  or twice;
- `header`: fields of a sequence or picture header that differ from what
  the configuration states (its format, and each stated coding parameter:
  the motion vector precision of inter pictures, the transform depth of
  pictures with a residual), over every stream of the window;
- `rate_excess_worst`: the most by which a stream's bytes exceed the
  configuration's bit rate's share of the clip's duration, as a share of
  that share, over every stream;
- `tile_mse_worst`: the worst 32x32 tile's mean squared error against the
  source, over every plane of every sampled frame (a garbled block, or a
  picture of another clip, shows there, where a whole frame's mean would
  hide it).

The low-delay check (`check_lowdelay`) reads the streams with `vc2spec`,
the decoder written from the standard's decoding process, alone:

- over every stream of the window, `header` (as above, and each picture
  unit that is not a low-delay picture), `budget_off` (pictures whose
  slices do not take exactly the configuration's `budget_bytes`, by their
  stated sizes or by their coded length) and `misnumbered`;
- over the sampled streams, `lost` (pictures that are not there, or do
  not decode) and `tile_mse_worst`, over `check_pictures` pictures of
  each (the mix's key; every picture where it has none), drawn from the
  seed.

Numbers are in the source's sample units; each has its limit in
`benchmark/limits/<cell>.json`.
"""
from __future__ import annotations

import numpy as np

import vc2spec
from refcodec import bitstream as rbs
from refcodec.coding.bitio import BitReader
from refcodec.decoder.core import StreamDecoder

# the sequence header's chroma format codes
CHROMA_CODES = {"444": 0, "422": 1, "420": 2}
TILE = 32     # samples a side of the tiles whose error is compared
RANGE = ("luma_offset", "luma_excursion", "chroma_offset",
         "chroma_excursion")
# the stated coding parameters under `vc2spec`'s names
SPEC_NAMES = {"wavelet_filter_index": "wavelet", "transform_depth": "depth"}


def _wanted(fmt):
    """The sequence header's fields as the configuration's format states
    them."""
    return {"width": fmt["width"], "height": fmt["height"],
            "chroma_format": CHROMA_CODES[fmt["chroma"]],
            "frame_rate_numerator": fmt["fps"],
            "frame_rate_denominator": 1,
            **{k: fmt[k] for k in RANGE},
            "interlaced_coding": bool(fmt.get("interlaced", False))}


def _header_mismatches(vf, fmt):
    """Fields of a decoded sequence header's format that differ from the
    configuration's format."""
    want = _wanted(fmt)
    got = {k: (int(getattr(vf, k)) if k != "interlaced_coding"
               else bool(vf.interlaced_coding)) for k in want}
    return sum(1 for k in want if got[k] != want[k])


def _stated_mismatches(stream, fmt, stated, device):
    """Each format field and stated coding parameter (`stated`: picture
    parameters' names and values; the motion vector precision is read
    from inter pictures, the others from pictures with a residual) that a
    header of the stream gives otherwise."""
    dec = StreamDecoder(device=device)
    bad = 0
    for code, payload in rbs.split_units(stream):
        if code == rbs.SEQUENCE_HEADER:
            dec.vf = rbs.read_sequence_header(BitReader(payload)).video_format
            bad += _header_mismatches(dec.vf, fmt)
        elif rbs.is_picture(code):
            try:
                _, p, _, _, _, _, zero_residual, _ = dec._parse_picture(
                    code, payload)
            except Exception:       # noqa: BLE001 - a header that does not
                bad += 1            # parse does not state what it should
                continue
            for k, v in stated.items():
                if (p.num_refs if k == "mv_precision"
                        else not zero_residual):
                    bad += int(getattr(p, k)) != v
    return bad


def decode_numbered(stream, device):
    """The reference's decode of a stream: ([(picture number, planes)] in
    coded order, pictures it could not decode)."""
    dec = StreamDecoder(device=device)
    out, errors = [], 0
    for code, payload in rbs.split_units(stream):
        if code == rbs.SEQUENCE_HEADER:
            dec.vf = rbs.read_sequence_header(BitReader(payload)).video_format
        elif rbs.is_picture(code):
            try:
                num, planes = dec.decode_picture_unit(code, payload)
            except Exception:       # noqa: BLE001 - whatever a damaged
                errors += 1         # picture raises, it is not decoded
                continue
            out.append((num, tuple(pl.cpu().numpy() for pl in planes)))
    return out, errors


def _tile_mse_worst(decoded, source):
    """The worst TILE x TILE tile's mean squared error over the planes of
    one decoded frame against its source frame."""
    worst = 0.0
    for d, s in zip(decoded, source):
        diff = d.astype(np.int64) - s.astype(np.int64)
        h, w = (diff.shape[0] // TILE) * TILE, (diff.shape[1] // TILE) * TILE
        t = np.square(diff[:h, :w], dtype=np.float64).reshape(
            h // TILE, TILE, w // TILE, TILE).mean(axis=(1, 3))
        worst = max(worst, float(t.max()))
    return worst


def check_encode(cfg, clips, outputs, device, sample, traffic, seed):
    """Numbers of an encode window whose `outputs` are (clip index,
    stream) pairs, each stream a whole clip; `sample` picks the outputs
    decoded whole and compared with their source (so the mix and the seed,
    which `CHECKS`' other entries read, go unused).  Returns (numbers,
    attempted, failed)."""
    fmt, stated = cfg["format"], cfg.get("stated", {})
    n = len(clips[0])
    share = cfg["encoder"]["bitrate"] / 8 * n / fmt["fps"]
    nums = {"lost": 0, "misnumbered": 0, "header": 0,
            "rate_excess_worst": -1.0, "tile_mse_worst": 0.0}
    for _, stream in outputs:
        nums["header"] = max(nums["header"], _stated_mismatches(
            stream, fmt, stated, device))
        nums["rate_excess_worst"] = max(nums["rate_excess_worst"],
                                        len(stream) / share - 1)
    failed = 0
    for i in sample:
        k, stream = outputs[i]
        pics, errors = decode_numbered(stream, device)
        got = {}
        for num, planes in pics:
            if num in got or not 0 <= num < n:
                nums["misnumbered"] += 1
            got[num] = planes
        lost = errors + sum(1 for j in range(n) if j not in got)
        nums["lost"] += lost
        failed += min(n, lost + len(pics) - len(got))
        for j, planes in got.items():
            if 0 <= j < n:
                nums["tile_mse_worst"] = max(
                    nums["tile_mse_worst"],
                    _tile_mse_worst(planes, clips[k][j]))
    return nums, len(outputs) * n, failed


def _spec_header_mismatches(seq, fmt):
    """Fields of a sequence header read by `vc2spec` that differ from the
    configuration's format."""
    want = _wanted(fmt)
    got = {"width": seq["width"], "height": seq["height"],
           "chroma_format": seq["chroma"],
           "frame_rate_numerator": seq["frame_rate"][0],
           "frame_rate_denominator": seq["frame_rate"][1],
           **{k: seq[k] for k in RANGE},
           "interlaced_coding": seq["fields"]}
    return sum(1 for k in want if got[k] != want[k])


def _read_lowdelay(stream, fmt, stated, budget):
    """The header pass over one low-delay stream: (header mismatches,
    pictures off the budget, [(picture number, picture unit, sequence
    header in force)] in stream order)."""
    try:
        units = vc2spec.parse_units(stream)
    except Exception:           # noqa: BLE001 - a stream whose parse infos
        return 1, 0, []         # do not chain states nothing
    header, budget_off, pictures, seq = 0, 0, [], None
    for code, data in units:
        if code == vc2spec.SEQUENCE_HEADER:
            try:
                seq = vc2spec.sequence_header(data)
            except Exception:   # noqa: BLE001 - a header that does not
                header += 1     # parse does not state what it should
                seq = None
                continue
            header += _spec_header_mismatches(seq, fmt)
        elif code & 0x08:       # a picture
            if not vc2spec.is_ld_picture(code) or seq is None:
                header += 1
                continue
            try:
                num, tp, off = vc2spec.picture_parameters(data)
                sizes = int(vc2spec.slice_bytes(tp).sum())
            except Exception:   # noqa: BLE001 - nor does a picture
                header += 1     # header that does not parse
                continue
            header += any(tp[SPEC_NAMES.get(k, k)] != v
                          for k, v in stated.items())
            budget_off += sizes != budget or len(data) - off != budget
            pictures.append((num, data, seq))
    return header, budget_off, pictures


def check_lowdelay(cfg, clips, outputs, device, sample, traffic, seed):
    """Numbers of a low-delay encode window, as `check_encode`'s, read
    with `vc2spec` alone (nothing of `refcodec` or of the program); the
    mix's `check_pictures` and the seed pick the pictures decoded, and
    `device` goes unused (the decoder is NumPy's).  `attempted` is the
    window's pictures, `failed` the lost ones of the sampled streams."""
    fmt, stated = cfg["format"], cfg.get("stated", {})
    n = len(clips[0])
    nums = {"lost": 0, "misnumbered": 0, "header": 0, "budget_off": 0,
            "tile_mse_worst": 0.0}
    read = []
    for _, stream in outputs:
        header, off, pictures = _read_lowdelay(stream, fmt, stated,
                                              fmt["budget_bytes"])
        nums["header"] = max(nums["header"], header)
        nums["budget_off"] += off
        seen = set()
        for num, _, _ in pictures:
            nums["misnumbered"] += num in seen or not 0 <= num < n
            seen.add(num)
        read.append(pictures)
    k = min(int(traffic.get("check_pictures", n)), n)
    rng = np.random.default_rng((int(seed), 1))
    failed = 0
    for i in sample:
        c = outputs[i][0]
        by_num = {}
        for num, data, seq in read[i]:
            by_num.setdefault(num, (data, seq))
        lost = sum(1 for j in range(n) if j not in by_num)
        for j in sorted(rng.choice(n, k, replace=False).tolist()):
            if j not in by_num:
                continue            # counted above
            try:
                _, planes = vc2spec.decode_picture(*by_num[j])
            except Exception:       # noqa: BLE001 - whatever a damaged
                lost += 1           # picture raises, it is not decoded
                continue
            nums["tile_mse_worst"] = max(nums["tile_mse_worst"],
                                         _tile_mse_worst(planes, clips[c][j]))
        nums["lost"] += lost
        failed += min(n, lost)
    return nums, len(outputs) * n, failed


CHECKS = {"longgop": check_encode, "lowdelay": check_lowdelay}
