#!/usr/bin/env python3
"""GOP structure dump (dump_gop equivalent): picture types, refs, sizes.

Usage: python -m schroedinger_tpu_torch.tools.dump_gop stream.drc

Copy of the JAX package's `tools/dump_gop.py` on the port's own host
modules; it prints the same text.
"""
import sys

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.coding.bitio import BitReader


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    data = open(argv[0], "rb").read()
    for code, payload in bs.split_units(data):
        if not bs.is_picture(code):
            continue
        r = BitReader(payload)
        num = r.read_bits(32)
        refs = [(num + r.read_sint()) & 0xFFFFFFFF
                for _ in range(bs.num_refs(code))]
        kind = "I" if bs.num_refs(code) == 0 else (
            "P" if bs.num_refs(code) == 1 else "B")
        ref_s = f" refs={refs}" if refs else ""
        flag = "*" if bs.is_reference(code) else " "
        print(f"{kind}{flag} pic {num:6d} {len(payload) + 13:8d} bytes{ref_s}")


if __name__ == "__main__":
    main()
