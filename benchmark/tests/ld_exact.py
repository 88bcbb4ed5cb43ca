"""An exact number for the low-delay check: the coefficients that
`vc2spec` dequantises from a stream against `ldref`'s analysis of the
source picture, quantised and dequantised at each slice's own quant
index as the stream states it:

    python3 benchmark/tests/ld_exact.py --seeds 1,2 [--clips 0,7]
        [--pictures 4] [--drop-bits 0] [--device cuda] [--size WxH]
        [--frames N]

For each seed the clips of the low-delay cell (`lowdelay_cell.py`) are
made as `run.run` makes them, and each of `--clips` is coded whole by a
new encoder of the configuration (`harness/codec.py`), with its source
samples' lowest `--drop-bits` bits cleared first (1: 9-bit samples in the
10-bit format, 2: 8-bit).  Of each stream, `--pictures` pictures drawn
from the seed as `check_lowdelay` draws them are read with
`vc2spec.decode_coefficients`; the reference takes the clip as made
through `ldref.prepare` and `ldref.bands`, quantises each coefficient at
its slice's index less the band's quant matrix entry with the dead-zone
quantiser of the reference encoder, and dequantises it; the LL band goes
through the standard's DC prediction (each value less the prediction
from its reconstructed left, upper and upper-left neighbours, in raster
order, the prediction dividing by three toward minus infinity as the
deep path does).  `differing` counts the coefficients where the two
differ: 0 is the only sound reading.  One JSON line per seed and clip;
exit 1 where a run with no bits dropped differs.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402,F401  (puts the repository on the path)
import ldref  # noqa: E402
import lowdelay_cell  # noqa: E402
import vc2spec  # noqa: E402
from harness import codec as hc  # noqa: E402
from harness import content  # noqa: E402


QF = np.array([ldref.quant_factor(q) for q in range(ldref.BASES)])
QO = np.array([ldref.quant_offset(q) for q in range(ldref.BASES)])


def quantise(v, qi):
    """The reference encoder's dead-zone quantiser at the indices `qi`."""
    qf, qo = QF[qi], QO[qi]
    x = 4 * np.abs(v)
    mag = np.where(x < qo, 0, (x - (qo - qf // 2)) // qf)
    return np.where(v < 0, -mag, mag)


def dequantise(q, qi):
    mag = (np.abs(q) * QF[qi] + QO[qi] + 2) >> 2
    return np.where(q == 0, 0, np.where(q < 0, -mag, mag))


def per_slice(qindex, shape):
    """Each position's slice index of a band of `shape`."""
    ny, nx = qindex.shape
    h, w = shape
    return np.repeat(np.repeat(qindex, h // ny, 0), w // nx, 1)


def dc_chain(ll, qi):
    """The LL band as the decoder rebuilds it: each value coded as its
    difference from the prediction of its reconstructed neighbours."""
    h, w = ll.shape
    rec = np.zeros((h, w), dtype=np.int64)
    for y in range(h):
        for x in range(w):
            if y and x:
                pred = (rec[y, x - 1] + rec[y - 1, x] + rec[y - 1, x - 1]
                        + 1) // 3
            elif y:
                pred = rec[y - 1, x]
            else:
                pred = rec[y, x - 1] if x else 0
            q = quantise(np.int64(ll[y, x] - pred), qi[y, x])
            rec[y, x] = pred + int(dequantise(q, qi[y, x]))
    return rec


def reference_bands(frame, bit_depth, chroma, depth, qindex, matrix):
    """[{(level, orientation): band}] of each component: the source's
    analysis, quantised and dequantised at the stream's indices."""
    vs, hs = ldref.CHROMA_SHIFTS[chroma]
    h, w = frame[0].shape
    out = []
    for k, plane in enumerate(frame):
        ph, pw = (h, w) if k == 0 else (h >> vs, w >> hs)
        p = plane if torch.is_tensor(plane) else torch.from_numpy(
            np.asarray(plane, np.int64))
        bl = [b.cpu().numpy() for b in ldref.bands(ldref.prepare(
            p.cpu(), bit_depth, ldref.padded(ph, depth),
            ldref.padded(pw, depth)), depth)]
        keys = [(0, 0)] + [(lev, o) for lev in range(1, depth + 1)
                           for o in range(3)]
        bands = {}
        for (lev, o), b in zip(keys, bl):
            qi = np.maximum(per_slice(qindex[k], b.shape) - matrix[lev][o],
                            0)
            bands[(lev, o)] = (dc_chain(b, qi) if lev == 0
                               else dequantise(quantise(b, qi), qi))
        out.append(bands)
    return out


def compare(seed, clips, n_pictures, drop, device, size=None, frames=None):
    _, cfg, traffic, _, _, _ = lowdelay_cell.load(10, {})
    fmt = dict(cfg["format"])
    if size:
        fmt["width"], fmt["height"] = size
        area = size[0] * size[1]
        fmt["budget_bytes"] = cfg["format"]["budget_bytes"] * area // (
            cfg["format"]["width"] * cfg["format"]["height"])
        cfg = dict(cfg, format=fmt)
    if frames:
        traffic["frames"] = frames
    made = content.make_clips(traffic, fmt["width"], fmt["height"],
                              fmt["chroma"], fmt["bit_depth"], seed, device)
    codec = hc.Codec(cfg, device)
    n = len(made[0])
    rng = np.random.default_rng((int(seed), 1))
    lines = []
    for k in clips:
        coded = [tuple((p >> drop) << drop for p in f) for f in made[k]]
        stream = codec.new_encoder().encode_stream(coded)
        t = time.perf_counter()
        seq, by_num = None, {}
        for code, data in vc2spec.parse_units(stream):
            if code == vc2spec.SEQUENCE_HEADER:
                seq = vc2spec.sequence_header(data)
            elif vc2spec.is_ld_picture(code):
                by_num[vc2spec.picture_parameters(data)[0]] = (data, seq)
        picked = sorted(rng.choice(n, min(n_pictures, n),
                                   replace=False).tolist())
        differing = {}
        for j in picked:
            data, sq = by_num[j]
            _, tp, off = vc2spec.picture_parameters(data)
            qindex, got = vc2spec.decode_coefficients(data, off, sq, tp)
            want = reference_bands(made[k][j], fmt["bit_depth"],
                                   fmt["chroma"], tp["depth"], qindex,
                                   tp["matrix"])
            differing[j] = [int(sum(np.count_nonzero(g[b] != w[b])
                                    for b in g))
                            for g, w in zip(got, want)]
        lines.append({"seed": seed, "clip": k, "drop_bits": drop,
                      "pictures": picked, "differing": differing,
                      "total": sum(sum(v) for v in differing.values()),
                      "seconds": time.perf_counter() - t,
                      "device": (torch.cuda.get_device_name(0)
                                 if torch.device(device).type == "cuda"
                                 else "cpu")})
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--clips", default="0,7")
    ap.add_argument("--pictures", type=int, default=4)
    ap.add_argument("--drop-bits", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None)
    ap.add_argument("--frames", type=int, default=None)
    a = ap.parse_args()
    size = tuple(int(x) for x in a.size.split("x")) if a.size else None
    clips = [int(c) for c in a.clips.split(",")]
    ok = True
    for seed in a.seeds.split(","):
        for line in compare(int(seed), clips, a.pictures, a.drop_bits,
                            a.device, size, a.frames):
            ok &= a.drop_bits > 0 or line["total"] == 0
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
