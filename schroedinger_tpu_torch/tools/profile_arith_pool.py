"""Serial against pooled arith coding of one picture's subbands, on the host.

    python -m schroedinger_tpu_torch.tools.profile_arith_pool [--sizes WxH,...]

For 4:2:0 pictures at transform depth 3 of each size, on quantised int16
bands made from a numpy seed as sparse as a coded picture's
(`make_bands`: most coefficients zero, the finest level the sparsest), it
times the native library's batch call alone
(`subband_encode_arith_batch`, as `native.encode_subbands_arith` makes
it) with the thread pool off and on: the median of `--repeat` calls after
a warm-up, the two in turns.  It prints one JSON line per size
(coefficients, bands, serial and pooled ms, pooled over serial, the
serial ns a coefficient) and a last line with the CPUs the pool may use
and the smallest size at which the pool won.  `native.POOL_MIN_COEFFS`
rests on that crossover (PERF.md, Findings).  It needs no card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from schroedinger_tpu_torch.coding import native

SIZES = ("64x32", "128x64", "192x96", "256x128", "384x192", "512x256",
         "960x544", "1920x1088")
# Laplace scale of the quantised coefficients by level, coarsest first
# (the DC band takes the first): a coded picture's bands are mostly zero,
# the finest the most
SCALES = (2.0, 0.4, 0.15, 0.06)


def make_bands(width, height, seed=0, depth=3):
    """The non-empty bands of a 4:2:0 picture, as encode_subbands_arith
    takes them: codeblocks 1x1 for band 0, 4x3 above it, one quant index
    a band."""
    rng = np.random.default_rng(seed)
    out = []
    for (w, h) in ((width, height), (width // 2, height // 2),
                   (width // 2, height // 2)):
        shapes = [(h >> depth, w >> depth)] + [
            (h >> (depth - (i - 1) // 3), w >> (depth - (i - 1) // 3))
            for i in range(1, 3 * depth + 1)]
        arrs = [np.round(rng.laplace(0, SCALES[0 if i == 0 else
                                               (i - 1) // 3 + 1], s))
                .astype(np.int16) for i, s in enumerate(shapes)]
        for i, a in enumerate(arrs):
            if not a.any():
                continue
            hcb, vcb = (1, 1) if i == 0 else (4, 3)
            out.append((a, arrs[i - 3] if i >= 4 else None, i, hcb, vcb,
                        False, np.full((vcb, hcb), 20, np.int32)))
    return out


def time_batch(bands, repeat):
    """(serial ms, pooled ms): medians of the batch call alone."""
    jobs, keep, _out, _offsets, _coeffs = native._arith_jobs(bands)
    call = native._lib.subband_encode_arith_batch
    times = {0: [], 1: []}
    for i in range(repeat + 2):
        for pooled in (0, 1) if i % 2 else (1, 0):
            t0 = time.perf_counter()
            call(jobs, len(jobs), pooled)
            if i >= 2:          # the first two rounds warm up
                times[pooled].append(time.perf_counter() - t0)
    del keep
    return (float(np.median(times[0])) * 1e3,
            float(np.median(times[1])) * 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(SIZES))
    ap.add_argument("--repeat", type=int, default=200)
    args = ap.parse_args(argv)
    crossover = None
    for size in args.sizes.split(","):
        w, h = (int(v) for v in size.split("x"))
        bands = make_bands(w, h)
        coeffs = sum(b[0].size for b in bands)
        serial, pooled = time_batch(bands, args.repeat)
        if crossover is None and pooled < serial:
            crossover = {"size": size, "coeffs": coeffs}
        print(json.dumps({"size": size, "coeffs": coeffs, "bands": len(bands),
                          "serial_ms": round(serial, 5),
                          "pooled_ms": round(pooled, 5),
                          "pooled_over_serial": round(pooled / serial, 4),
                          "serial_ns_per_coeff": round(serial * 1e6 / coeffs,
                                                       3)}))
    print(json.dumps({"cpus": native.arith_pool_cpus(),
                      "pool_min_coeffs": native.POOL_MIN_COEFFS,
                      "crossover": crossover}))


if __name__ == "__main__":
    main()
