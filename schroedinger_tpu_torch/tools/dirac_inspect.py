#!/usr/bin/env python3
"""Dirac/VC-2 stream inspector — the dump_packets debugging workhorse
(reference: tools/dump_packets.c).

Usage: python -m schroedinger_tpu_torch.tools.dirac_inspect stream.drc [-v]

Copy of the JAX package's `tools/dirac_inspect.py` on the port's own
host modules; it prints the same text.
"""
import argparse

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.params import Params
from schroedinger_tpu_torch.wavelets import Wavelet

PARSE_NAMES = {
    0x00: "sequence_header", 0x10: "end_of_sequence", 0x20: "auxiliary_data",
    0x30: "padding",
}


def describe_code(code: int) -> str:
    if code in PARSE_NAMES:
        return PARSE_NAMES[code]
    if bs.is_picture(code):
        kind = []
        kind.append("lowdelay" if bs.is_lowdelay(code) else
                    ("intra" if bs.num_refs(code) == 0 else
                     f"inter_{bs.num_refs(code)}ref"))
        kind.append("ref" if bs.is_reference(code) else "nonref")
        kind.append("arith" if bs.using_ac(code) else "vlc")
        return "picture(" + ",".join(kind) + ")"
    return f"unknown_{code:#04x}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("stream")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    data = open(args.stream, "rb").read()
    vf = None
    offset = 0
    for code, payload in bs.split_units(data):
        size = len(payload) + bs.PARSE_HEADER_SIZE
        print(f"{offset:10d}: {describe_code(code):32s} {size:8d} bytes")
        if code == bs.SEQUENCE_HEADER:
            info = bs.read_sequence_header(BitReader(payload))
            vf = info.video_format
            print(f"{'':12s} profile {info.profile} level {info.level} "
                  f"{vf.width}x{vf.height} chroma {vf.chroma_format.name} "
                  f"{vf.frame_rate_numerator}/{vf.frame_rate_denominator}fps")
        elif bs.is_picture(code) and vf is not None and args.verbose:
            r = BitReader(payload)
            num = r.read_bits(32)
            refs = [(num + r.read_sint()) & 0xFFFFFFFF
                    for _ in range(bs.num_refs(code))]
            line = f"{'':12s} picture {num}"
            if refs:
                line += f" refs {refs}"
            if bs.is_reference(code):
                line += f" retire {(num + r.read_sint()) & 0xFFFFFFFF}"
            print(line)
            if bs.num_refs(code) == 0:
                r.sync()
                p = Params(video_format=vf, num_refs=0,
                           is_lowdelay=bs.is_lowdelay(code),
                           is_noarith=not bs.using_ac(code))
                bs.read_transform_parameters(r, p)
                print(f"{'':12s} wavelet {Wavelet(p.wavelet_filter_index).name}"
                      f" depth {p.transform_depth}"
                      + (f" slices {p.n_horiz_slices}x{p.n_vert_slices}"
                         f" bytes {p.slice_bytes_num}/{p.slice_bytes_denom}"
                         if p.is_lowdelay else ""))
        offset += size


if __name__ == "__main__":
    main()
