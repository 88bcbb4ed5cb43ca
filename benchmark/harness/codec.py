"""The system under test: the port's public entry points, built from a
configuration file.  This is the only module of the benchmark that
imports the program (`schroedinger_tpu_torch`); what it hands the
program are the source frames the benchmark made, and what it takes back
are bytes and pictures, and the program's event counters.
"""
from __future__ import annotations

from schroedinger_tpu_torch import api
from schroedinger_tpu_torch.config import EncoderConfig
from schroedinger_tpu_torch.decoder.streaming import StreamingDecoder
from schroedinger_tpu_torch.utils import telemetry
from schroedinger_tpu_torch.video_format import ChromaFormat, VideoFormat

CHROMA = {"444": ChromaFormat.C444, "422": ChromaFormat.C422,
          "420": ChromaFormat.C420}


def video_format(fmt, bit_depth=None):
    """The configuration's format; `bit_depth` 8 asks for the 8-bit form
    of a deep format (full range offsets, as the program's 8-bit path
    codes it)."""
    deep = (bit_depth or fmt["bit_depth"]) > 8
    vf = VideoFormat(
        width=fmt["width"], height=fmt["height"], clean_width=fmt["width"],
        clean_height=fmt["height"], chroma_format=CHROMA[fmt["chroma"]],
        frame_rate_numerator=fmt["fps"], frame_rate_denominator=1,
        **({k: fmt[k] for k in ("luma_offset", "luma_excursion",
                                "chroma_offset", "chroma_excursion")}
           if deep else {}))
    return vf


class Codec:
    """Factories of the program's encoders and decoders for one
    configuration, on `device`."""

    def __init__(self, cfg, device, bit_depth=None):
        self.fmt = cfg["format"]
        self.settings = cfg["encoder"]
        self.device = device
        self.bit_depth = bit_depth or self.fmt["bit_depth"]
        self.vf = video_format(self.fmt, self.bit_depth)
        if self.vf.bit_depth != self.bit_depth:
            raise ValueError(f"the format codes {self.vf.bit_depth} bits, "
                             f"the configuration asks for {self.bit_depth}")

    def new_encoder(self):
        return api.Encoder(video_format(self.fmt, self.bit_depth),
                           EncoderConfig(**self.settings),
                           device=self.device)

    def new_streaming_decoder(self):
        return StreamingDecoder(coded_order=True, device=self.device)

    def counters(self):
        """The program's process-wide event counters ({name: count}: the
        bytes copied to and from the card, the kernels' launches)."""
        return telemetry.counters.snapshot()
