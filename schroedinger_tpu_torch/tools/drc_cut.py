#!/usr/bin/env python3
"""Cut a Dirac stream at sequence-header boundaries (drc-cut equivalent).

Usage: python -m schroedinger_tpu_torch.tools.drc_cut in.drc out.drc
           --start N --count M
Units are pictures; cuts snap to the sequence header at/before --start.

Copy of the JAX package's `tools/drc_cut.py` on the port's own host
modules; it writes the same bytes.
"""
import argparse

from schroedinger_tpu_torch import bitstream as bs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=None)
    args = ap.parse_args(argv)

    data = open(args.infile, "rb").read()
    units = bs.split_units(data)

    # group into segments starting at sequence headers
    kept = []
    pictures = 0
    started = False
    pending = []
    for code, payload in units:
        if code == bs.END_OF_SEQUENCE:
            continue
        w = bs.BitWriter()
        bs.write_parse_info(w, code)
        raw = w.get_bytes() + payload
        if code == bs.SEQUENCE_HEADER:
            pending = [raw]
            continue
        if bs.is_picture(code):
            if pictures >= args.start and (args.count is None
                                           or len([u for u in kept
                                                   if bs.is_picture(u[4])])
                                           < args.count):
                if pending:
                    kept.extend(pending)
                    pending = []
                    started = True
                if started:
                    kept.append(raw)
            pictures += 1
        elif started:
            kept.append(raw)
        else:
            pending.append(raw)
    kept.append(bs.make_eos_unit())
    open(args.outfile, "wb").write(bs.fixup_offsets(kept))
    n_pics = sum(1 for u in kept if bs.is_picture(u[4]))
    print(f"wrote {len(kept)} units ({n_pics} pictures)")


if __name__ == "__main__":
    main()
