"""The program's VC-2 low-delay streams held to the standard's decoding
process (`vc2spec.py`), at the low-delay configuration's own size:

    python3 benchmark/tests/vc2_conformance.py --seeds 1,2,3
        [--pictures 4] [--device cuda] [--size WxH]

For each seed the encode-live mix's clip is coded by the program's live
API at the configuration's ten bits and on the program's eight-bit path
(the source's top eight bits), and each picture is decoded both by the
program's streaming decoder and by `vc2spec`.  One JSON line per seed and
depth gives, per plane, the samples where the two decodes differ, the
largest difference, and each decode's mean error against the source.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402  (puts the repository on the path)
import vc2spec  # noqa: E402
from harness import content, drive  # noqa: E402
from harness.codec import Codec  # noqa: E402

CONFIG = "vc2-lowdelay-1080p25-422p10"


def compare(seed, bit_depth, pictures, device, size=None):
    cfg = json.load(open(os.path.join(HERE, "..", "configs",
                                      CONFIG + ".json")))
    traffic = json.load(open(os.path.join(HERE, "..", "traffic",
                                          "encode-live.json")))
    fmt = cfg["format"]
    if size:
        fmt["width"], fmt["height"] = size
    traffic["frames"] = pictures
    clip = content.make_clips(traffic, fmt["width"], fmt["height"],
                              fmt["chroma"], fmt["bit_depth"], seed,
                              device)[0]
    shift = fmt["bit_depth"] - bit_depth
    if shift:
        clip = [tuple((p >> shift).astype(np.uint8) for p in f)
                for f in clip]
    codec = Codec(cfg, device, bit_depth)
    _, _, _, units = drive.encode_live(codec, [clip], 0.0, device,
                                       min_items=pictures)
    dec = codec.new_streaming_decoder()
    out = {"seed": seed, "bit_depth": bit_depth, "pictures": pictures,
           "differing": [0, 0, 0], "max_gap": [0, 0, 0],
           "program_mean_error": [0.0] * 3, "reference_mean_error": [0.0] * 3,
           "reference_s": 0.0}
    for i, unit in enumerate(units):
        dec.push(unit)
        got = dec.pull()[1]
        t = time.perf_counter()
        (num, want), = vc2spec.decode_stream(unit)
        out["reference_s"] += time.perf_counter() - t
        assert num == i
        for k in range(3):
            g = np.asarray(got[k].cpu() if hasattr(got[k], "cpu")
                           else got[k]).astype(np.int64)
            w = want[k].astype(np.int64)
            s = clip[i][k].astype(np.int64)
            out["differing"][k] += int(np.count_nonzero(g != w))
            out["max_gap"][k] = max(out["max_gap"][k],
                                    int(np.abs(g - w).max()))
            out["program_mean_error"][k] += float((g - s).mean()) / pictures
            out["reference_mean_error"][k] += float((w - s).mean()) / pictures
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pictures", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None)
    a = ap.parse_args()
    size = tuple(int(x) for x in a.size.split("x")) if a.size else None
    for seed in a.seeds.split(","):
        for depth in (10, 8):
            print(json.dumps(compare(int(seed), depth, a.pictures, a.device,
                                     size)), flush=True)


if __name__ == "__main__":
    main()
