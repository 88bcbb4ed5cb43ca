"""Dirac/VC-2 stream container: parse-info framing, sequence header, parse.

Reference behavior: parse units start with 'BBCD' + parse code + next/prev
offsets (schroencoder.c schro_encoder_encode_parse_info, fixup at
schroencoder.c:1427-1452); sequence header syntax per
schro_encoder_encode_sequence_header_header (schroencoder.c:3146-3290).

Whole copy of `schroedinger_tpu/bitstream.py`: the port imports nothing of
the JAX package, and later slices find their entry points here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from schroedinger_tpu_torch.coding.bitio import BitReader, BitWriter
from schroedinger_tpu_torch.params import Params
from schroedinger_tpu_torch.video_format import (ChromaFormat, STD_ASPECT_RATIOS,
                                           STD_FRAME_RATES, STD_SIGNAL_RANGES,
                                           VideoFormat, std_video_format)
from schroedinger_tpu_torch.wavelets import Wavelet

PARSE_HEADER_SIZE = 13

# Parse codes (schrobitstream.h:11-34)
SEQUENCE_HEADER = 0x00
END_OF_SEQUENCE = 0x10
AUXILIARY_DATA = 0x20
PADDING = 0x30
LD_INTRA_REF = 0xCC
LD_INTRA_NON_REF = 0xC8


def parse_code_picture(is_ref: bool, n_refs: int, is_lowdelay: bool,
                       is_noarith: bool) -> int:
    """SCHRO_PARSE_CODE_PICTURE macro (schrobitstream.h:36-37)."""
    return (0x08 | (0x4 if is_ref else 0) | (n_refs & 3)
            | (0x80 if is_lowdelay else 0) | (0x40 if is_noarith else 0))


def is_picture(code: int) -> bool:
    return bool(code & 0x8)


def is_lowdelay(code: int) -> bool:
    return (code & 0x88) == 0x88


def using_ac(code: int) -> bool:
    return (code & 0x48) == 0x08


def num_refs(code: int) -> int:
    return code & 0x3


def is_reference(code: int) -> bool:
    return (code & 0xC) == 0xC


def write_parse_info(w: BitWriter, parse_code: int) -> None:
    w.write_bits(8, ord("B"))
    w.write_bits(8, ord("B"))
    w.write_bits(8, ord("C"))
    w.write_bits(8, ord("D"))
    w.write_bits(8, parse_code)
    w.write_bits(32, 0)  # next_parse_offset, fixed up later
    w.write_bits(32, 0)  # prev_parse_offset, fixed up later


def fixup_offsets(units: List[bytes], final_eos: bool = True,
                  prev: int = 0) -> bytes:
    """Set next/prev parse offsets across a list of parse units.

    `prev` is the next_parse_offset of the unit immediately before this
    batch (the previous unit's length); the parse sync state machine
    validates the chain (schroparse.c), so it must be threaded across
    batches — see chain_offsets for stateful use.
    """
    out = bytearray()
    for i, u in enumerate(units):
        u = bytearray(u)
        is_eos = final_eos and i == len(units) - 1 and u[4] == END_OF_SEQUENCE
        nxt = 0 if is_eos else len(u)
        u[5:9] = nxt.to_bytes(4, "big")
        u[9:13] = prev.to_bytes(4, "big")
        prev = nxt
        out += u
    return bytes(out)


class OffsetChain:
    """Stateful parse-offset fixup across successive unit batches."""

    def __init__(self):
        self.prev = 0

    def add(self, units: List[bytes], final_eos: bool = False) -> bytes:
        out = fixup_offsets(units, final_eos=final_eos, prev=self.prev)
        if units:
            last = units[-1]
            self.prev = 0 if (final_eos and last[4] == END_OF_SEQUENCE) \
                else len(last)
        return out


def make_eos_unit() -> bytes:
    w = BitWriter()
    write_parse_info(w, END_OF_SEQUENCE)
    return w.get_bytes()


def make_padding_unit(n: int) -> bytes:
    """PADDING parse unit of n total bytes (>= the 13-byte parse header):
    the CBR reservoir-overrun filler (schro_encoder_encode_padding,
    schroencoder.c:1456-1479)."""
    n = max(n, PARSE_HEADER_SIZE)
    w = BitWriter()
    write_parse_info(w, PADDING)
    return w.get_bytes() + bytes(n - PARSE_HEADER_SIZE)


# Auxiliary data codes (schrobitstream.h:141-146)
AUX_ENCODER_STRING = 1
AUX_SMPTE_12M_TIMECODE = 2
AUX_MD5_CHECKSUM = 3
AUX_BITRATE = 4


def make_aux_unit(aux_code: int, data: bytes) -> bytes:
    w = BitWriter()
    write_parse_info(w, AUXILIARY_DATA)
    w.write_bits(8, aux_code)
    for b in data:
        w.write_bits(8, b)
    return w.get_bytes()


# ---------------------------------------------------------------------------
# Sequence header

@dataclasses.dataclass
class SequenceHeaderInfo:
    video_format: VideoFormat
    profile: int = 0
    level: int = 0
    version_major: int = 2
    version_minor: int = 2
    interlaced_coding: int = 0


def write_sequence_header(vf: VideoFormat, profile: int, level: int,
                          version=(2, 2)) -> bytes:
    """Serialize a sequence header parse unit (offsets unfixed)."""
    w = BitWriter()
    write_parse_info(w, SEQUENCE_HEADER)
    w.write_uint(version[0])
    w.write_uint(version[1])
    w.write_uint(profile)
    w.write_uint(level)

    std = std_video_format(vf.index)
    if vf.interlaced and std.top_field_first != vf.top_field_first:
        # top_field_first is only expressible through the base index
        # (schrovideoformat.c:295-299): re-pick one that matches
        from schroedinger_tpu_torch.video_format import guess_std_index
        std = std_video_format(guess_std_index(vf))
    w.write_uint(std.index)

    if std.width == vf.width and std.height == vf.height:
        w.write_bit(0)
    else:
        w.write_bit(1)
        w.write_uint(vf.width)
        w.write_uint(vf.height)

    if std.chroma_format == vf.chroma_format:
        w.write_bit(0)
    else:
        w.write_bit(1)
        w.write_uint(int(vf.chroma_format))

    if std.interlaced == vf.interlaced:
        w.write_bit(0)
    else:
        w.write_bit(1)
        w.write_uint(int(vf.interlaced))

    fr = (vf.frame_rate_numerator, vf.frame_rate_denominator)
    if (std.frame_rate_numerator, std.frame_rate_denominator) == fr:
        w.write_bit(0)
    else:
        w.write_bit(1)
        idx = STD_FRAME_RATES.index(fr) if fr in STD_FRAME_RATES else 0
        w.write_uint(idx)
        if idx == 0:
            w.write_uint(fr[0])
            w.write_uint(fr[1])

    ar = (vf.aspect_ratio_numerator, vf.aspect_ratio_denominator)
    if (std.aspect_ratio_numerator, std.aspect_ratio_denominator) == ar:
        w.write_bit(0)
    else:
        w.write_bit(1)
        idx = STD_ASPECT_RATIOS.index(ar) if ar in STD_ASPECT_RATIOS else 0
        w.write_uint(idx)
        if idx == 0:
            w.write_uint(ar[0])
            w.write_uint(ar[1])

    if (std.clean_width == vf.clean_width and std.clean_height == vf.clean_height
            and std.left_offset == vf.left_offset and std.top_offset == vf.top_offset):
        w.write_bit(0)
    else:
        w.write_bit(1)
        w.write_uint(vf.clean_width)
        w.write_uint(vf.clean_height)
        w.write_uint(vf.left_offset)
        w.write_uint(vf.top_offset)

    sr = (vf.luma_offset, vf.luma_excursion, vf.chroma_offset, vf.chroma_excursion)
    if sr == (std.luma_offset, std.luma_excursion, std.chroma_offset,
              std.chroma_excursion):
        w.write_bit(0)
    else:
        w.write_bit(1)
        idx = STD_SIGNAL_RANGES.index(sr) if sr in STD_SIGNAL_RANGES else 0
        w.write_uint(idx)
        if idx == 0:
            for v in sr:
                w.write_uint(v)

    cs = (vf.colour_primaries, vf.colour_matrix, vf.transfer_function)
    if cs == (std.colour_primaries, std.colour_matrix, std.transfer_function):
        w.write_bit(0)
    else:
        w.write_bit(1)
        # emit as custom (index 0) with explicit values
        w.write_uint(0)
        w.write_bit(1)
        w.write_uint(vf.colour_primaries)
        w.write_bit(1)
        w.write_uint(vf.colour_matrix)
        w.write_bit(1)
        w.write_uint(vf.transfer_function)

    w.write_uint(int(vf.interlaced_coding))
    w.sync()
    return w.get_bytes()


def read_sequence_header(r: BitReader) -> SequenceHeaderInfo:
    """Parse a sequence header (after parse info). Mirrors
    schrodecoder.c:2214-2375."""
    version_major = r.read_uint()
    version_minor = r.read_uint()
    profile = r.read_uint()
    level = r.read_uint()

    index = r.read_uint()
    vf = std_video_format(index)

    if r.read_bit():
        vf.width = r.read_uint()
        vf.height = r.read_uint()
    if r.read_bit():
        vf.chroma_format = ChromaFormat(r.read_uint())
    if r.read_bit():
        vf.interlaced = bool(r.read_uint())
    if r.read_bit():
        idx = r.read_uint()
        if idx == 0:
            vf.frame_rate_numerator = r.read_uint()
            vf.frame_rate_denominator = r.read_uint()
        else:
            vf.frame_rate_numerator, vf.frame_rate_denominator = STD_FRAME_RATES[idx]
    if r.read_bit():
        idx = r.read_uint()
        if idx == 0:
            vf.aspect_ratio_numerator = r.read_uint()
            vf.aspect_ratio_denominator = r.read_uint()
        else:
            (vf.aspect_ratio_numerator,
             vf.aspect_ratio_denominator) = STD_ASPECT_RATIOS[idx]
    if r.read_bit():
        vf.clean_width = r.read_uint()
        vf.clean_height = r.read_uint()
        vf.left_offset = r.read_uint()
        vf.top_offset = r.read_uint()
    if r.read_bit():
        idx = r.read_uint()
        if idx == 0:
            vf.luma_offset = r.read_uint()
            vf.luma_excursion = r.read_uint()
            vf.chroma_offset = r.read_uint()
            vf.chroma_excursion = r.read_uint()
        else:
            (vf.luma_offset, vf.luma_excursion, vf.chroma_offset,
             vf.chroma_excursion) = STD_SIGNAL_RANGES[idx]
    if r.read_bit():
        idx = r.read_uint()
        if idx == 0:
            if r.read_bit():
                vf.colour_primaries = r.read_uint()
            if r.read_bit():
                vf.colour_matrix = r.read_uint()
            if r.read_bit():
                vf.transfer_function = r.read_uint()
    vf.interlaced_coding = bool(r.read_uint())
    return SequenceHeaderInfo(video_format=vf, profile=profile, level=level,
                              version_major=version_major,
                              version_minor=version_minor)


def split_units(stream: bytes):
    """Split a Dirac stream into parse units [(parse_code, payload_bytes)].

    payload excludes the 13-byte parse info. Tolerates a truncated tail.
    """
    units = []
    pos = 0
    n = len(stream)
    while pos + PARSE_HEADER_SIZE <= n:
        if stream[pos:pos + 4] != b"BBCD":
            # resync: scan forward for marker (schroparse.c behavior)
            idx = stream.find(b"BBCD", pos)
            if idx < 0:
                break
            pos = idx
            continue
        code = stream[pos + 4]
        next_off = int.from_bytes(stream[pos + 5:pos + 9], "big")
        if next_off == 0:
            if code == END_OF_SEQUENCE:
                units.append((code, b""))
                break
            next_off = n - pos
        units.append((code, stream[pos + PARSE_HEADER_SIZE:pos + next_off]))
        pos += next_off
    return units


# ---------------------------------------------------------------------------
# Picture-level headers

def write_picture_header(w: BitWriter, frame_number: int,
                         ref_deltas=(), retired_delta=None) -> None:
    """schroencoder.c schro_encoder_encode_picture_header."""
    w.sync()
    w.write_bits(32, frame_number)
    for d in ref_deltas:
        w.write_sint(d)
    if retired_delta is not None:
        w.write_sint(retired_delta)


def write_transform_parameters(w: BitWriter, p: Params) -> None:
    """schroencoder.c schro_encoder_encode_transform_parameters."""
    if p.num_refs > 0:
        w.write_bit(0)  # zero residual
    w.write_uint(int(p.wavelet_filter_index))
    w.write_uint(p.transform_depth)
    if not p.is_lowdelay:
        is_default = all(p.horiz_codeblocks[i] == 1 and p.vert_codeblocks[i] == 1
                         for i in range(p.transform_depth + 1)) \
            and p.codeblock_mode_index == 0
        if is_default:
            w.write_bit(0)
        else:
            w.write_bit(1)
            for i in range(p.transform_depth + 1):
                w.write_uint(p.horiz_codeblocks[i])
                w.write_uint(p.vert_codeblocks[i])
            w.write_uint(p.codeblock_mode_index)
    else:
        w.write_uint(p.n_horiz_slices)
        w.write_uint(p.n_vert_slices)
        w.write_uint(p.slice_bytes_num)
        w.write_uint(p.slice_bytes_denom)
        if p.is_default_quant_matrix():
            w.write_bit(0)
        else:
            w.write_bit(1)
            w.write_uint(p.quant_matrix[0])
            for i in range(p.transform_depth):
                w.write_uint(p.quant_matrix[1 + 3 * i])
                w.write_uint(p.quant_matrix[2 + 3 * i])
                w.write_uint(p.quant_matrix[3 + 3 * i])


def read_transform_parameters(r: BitReader, p: Params) -> None:
    """Mirror of write_transform_parameters (schrodecoder.c:2817+)."""
    if p.num_refs > 0:
        zero_residual = r.read_bit()
        p.zero_residual = bool(zero_residual)  # type: ignore[attr-defined]
    p.wavelet_filter_index = Wavelet(r.read_uint())
    p.transform_depth = r.read_uint()
    if not p.is_lowdelay:
        if r.read_bit():
            for i in range(p.transform_depth + 1):
                p.horiz_codeblocks[i] = r.read_uint()
                p.vert_codeblocks[i] = r.read_uint()
            p.codeblock_mode_index = r.read_uint()
        else:
            for i in range(p.transform_depth + 1):
                p.horiz_codeblocks[i] = 1
                p.vert_codeblocks[i] = 1
            p.codeblock_mode_index = 0
    else:
        p.n_horiz_slices = r.read_uint()
        p.n_vert_slices = r.read_uint()
        p.slice_bytes_num = r.read_uint()
        p.slice_bytes_denom = r.read_uint()
        if r.read_bit():
            p.quant_matrix[0] = r.read_uint()
            for i in range(p.transform_depth):
                p.quant_matrix[1 + 3 * i] = r.read_uint()
                p.quant_matrix[2 + 3 * i] = r.read_uint()
                p.quant_matrix[3 + 3 * i] = r.read_uint()
        else:
            p.set_default_quant_matrix()
