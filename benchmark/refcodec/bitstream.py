"""Dirac/VC-2 stream container: parse-info framing, sequence header, parse.

Reference behavior: parse units start with 'BBCD' + parse code + next/prev
offsets (schroencoder.c schro_encoder_encode_parse_info, fixup at
schroencoder.c:1427-1452); sequence header syntax per
schro_encoder_encode_sequence_header_header (schroencoder.c:3146-3290).

A frozen copy of the port's `bitstream.py`, cut to what the reference
decoder reads.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from refcodec.coding.bitio import BitReader
from refcodec.video_format import (ChromaFormat, STD_ASPECT_RATIOS,
                                           STD_FRAME_RATES, STD_SIGNAL_RANGES,
                                           VideoFormat, std_video_format)

PARSE_HEADER_SIZE = 13

# Parse codes (schrobitstream.h:11-34)
SEQUENCE_HEADER = 0x00
END_OF_SEQUENCE = 0x10
AUXILIARY_DATA = 0x20
PADDING = 0x30


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


@dataclasses.dataclass
class SequenceHeaderInfo:
    video_format: VideoFormat
    profile: int = 0
    level: int = 0
    version_major: int = 2
    version_minor: int = 2
    interlaced_coding: int = 0


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
