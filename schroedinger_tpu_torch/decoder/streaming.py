"""Streaming push/pull decoder: incremental parse sync, reorder buffer,
coded-order output, trick modes, mid-stream sequence-header changes.

A re-expression of the reference's SchroDecoder push/pull API
(schrodecoder.h:174-203) and the SchroParseSyncState machine
(schroparse.c:216-330): bytes are pushed in arbitrary-sized pieces, the
sync machine validates the next/prev parse-offset chain (tolerating
garbage and mid-stream joins), decoded pictures land in a reorder buffer
sized per schro_decoder_set_rob_size (schrodecoder.c:3733-3756: 1 in
coded order, 2+1 progressive, 4+1 interlaced), and pull() emits the
lowest-numbered buffered picture once the buffer is full (or on flush).
Trick modes follow schrodecoder.c:1325-1355: earliest_frame skips
non-reference pictures below a target, skip_ratio drops non-reference
pictures through an EMA duty-cycle (SCHRO_SKIP_TIME_CONSTANT 0.1).

Port of `schroedinger_tpu/decoder/streaming.py`: the parse machine and
the buffers are host code, the pictures decode through the port's
`StreamDecoder` on `device` (None: the card) one at a time, and each
comes back to the host as numpy planes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.coding import native as _native
from schroedinger_tpu_torch.coding.bitio import BitReader
from schroedinger_tpu_torch.decoder.core import BrokenPicture, StreamDecoder

PARSE_HEADER = 13
_SKIP_TC = 0.1  # SCHRO_SKIP_TIME_CONSTANT, schrodecoder.c:26


def _parse_info(buf, off: int):
    """Decode the 13-byte parse info at off, or None if invalid."""
    if buf[off:off + 4] != b"BBCD":
        return None
    code = buf[off + 4]
    npo = int.from_bytes(buf[off + 5:off + 9], "big")
    ppo = int.from_bytes(buf[off + 9:off + 13], "big")
    return code, npo, ppo


class ParseSync:
    """Incremental NOT_SYNCED -> TRY_SYNC -> SYNCED machine over pushed
    byte pieces (schro_parse_sync, schroparse.c:216-330).  pull_unit()
    yields complete (parse_code, payload) units; garbage between units
    causes a resync that validates the offset chain both ways."""

    NOT_SYNCED, TRY_SYNC, SYNCED = 0, 1, 2

    def __init__(self):
        self._buf = bytearray()
        self._base = 0            # stream offset of _buf[0]
        self._offset = 0          # absolute scan position
        self._state = self.NOT_SYNCED
        self._last_npo = 0
        self._done_special_startup = False

    def push(self, data: bytes) -> None:
        self._buf += data

    def _avail(self) -> int:
        return self._base + len(self._buf)

    def _peek(self, off: int, n: int) -> Optional[bytes]:
        i = off - self._base
        if i < 0 or i + n > len(self._buf):
            return None
        return bytes(self._buf[i:i + n])

    def _compact(self) -> None:
        drop = self._offset - self._base
        if drop > (1 << 16):
            del self._buf[:drop]
            self._base = self._offset

    def pull_unit(self) -> Optional[Tuple[int, bytes]]:
        while True:
            if self._state == self.NOT_SYNCED:
                i = self._buf.find(b"BBCD", max(0, self._offset - self._base))
                if i < 0:
                    # keep a 3-byte tail in case BBCD straddles pushes
                    self._offset = max(self._avail() - 3, self._offset)
                    self._compact()
                    return None
                self._offset = self._base + i
                hdr = self._peek(self._offset, PARSE_HEADER)
                if hdr is None:
                    return None
                if not self._done_special_startup and self._offset == 0:
                    # special startup (schroparse.c:276-291): the very
                    # first buffer may hold a single data unit; synced
                    # IFF its next_parse_offset is fully available
                    self._done_special_startup = True
                    pu = _parse_info(hdr, 0)
                    if pu is not None:
                        code, npo, ppo = pu
                        if (npo == 0
                                or self._peek(npo - 1, 1) is not None):
                            # emit this unit unconditionally (the C goes
                            # straight to extract): seed the chain check
                            self._last_npo = ppo
                            self._state = self.SYNCED
                            continue
                self._state = self.TRY_SYNC
                continue
            if self._state == self.TRY_SYNC:
                hdr = self._peek(self._offset, PARSE_HEADER)
                if hdr is None:
                    return None
                pu1 = _parse_info(hdr, 0)
                ok = pu1 is not None
                if ok:
                    _, _, ppo1 = pu1
                    ok = (ppo1 > 0 and self._offset - ppo1 >= self._base)
                if ok:
                    prev = self._peek(self._offset - ppo1, PARSE_HEADER)
                    pu0 = _parse_info(prev, 0) if prev else None
                    ok = pu0 is not None and pu0[1] == ppo1
                if not ok:
                    self._offset += 1
                    self._state = self.NOT_SYNCED
                    continue
                # rewind to the validated earlier unit and emit it
                # directly (the C's goto extract): seed the chain check
                # with its own prev offset so SYNCED accepts it
                self._offset -= ppo1
                self._last_npo = pu0[2]
                self._state = self.SYNCED
                continue
            # SYNCED: emit the unit at _offset if fully available
            hdr = self._peek(self._offset, PARSE_HEADER)
            if hdr is None:
                return None
            pu = _parse_info(hdr, 0)
            if pu is None or (self._last_npo != pu[2]):
                self._state = self.NOT_SYNCED
                continue
            code, npo, ppo = pu
            length = npo if npo else PARSE_HEADER
            unit = self._peek(self._offset, length)
            if unit is None:
                return None   # incomplete data unit: wait for more bytes
            self._offset += length
            self._last_npo = npo
            self._compact()
            return code, unit[PARSE_HEADER:]


class StreamingDecoder:
    """Push/pull decoder (schro_decoder_autoparse_push / _pull analog).

    push(data) accepts arbitrary byte pieces; pull() returns the next
    (picture_number, (y, u, v)) in presentation order (coded order when
    coded_order=True) or None when more bits are needed.  Call
    push_end_of_sequence() (or push a stream containing EOS) then drain
    pull() for the tail.  MD5 verification and per-picture error records
    are inherited from the core decoder (md5_failures / errors).  The
    pictures decode on `device`: the card when None, the CPU on
    request."""

    def __init__(self, coded_order: bool = False, device=None):
        self._sync = ParseSync()
        self._core = StreamDecoder(device=device)
        self.coded_order = coded_order
        self._rob: List[Tuple[int, tuple]] = []
        self._drain_first: List[Tuple[int, tuple]] = []
        self._rob_size = 1 if coded_order else 3
        self._seq_header_bytes: Optional[bytes] = None
        self.flushing = False
        self.eos_seen = False
        self.earliest_frame = 0
        self.skip_ratio = 1.0
        self._skip_value = 0.0
        self.skipped: List[int] = []

    # ---- configuration (schrodecoder.c:589-647) ----
    def set_earliest_frame(self, n: int) -> None:
        self.earliest_frame = n

    def set_skip_ratio(self, ratio: float) -> None:
        self.skip_ratio = min(max(ratio, 0.0), 1.0)

    @property
    def md5_failures(self):
        return self._core.md5_failures

    @property
    def errors(self):
        return self._core.errors

    # ---- push side ----
    def push(self, data: bytes) -> None:
        self._sync.push(data)
        self._process()

    def push_end_of_sequence(self) -> None:
        self.push(bs.make_eos_unit())

    def _adopt_sequence_header(self, payload: bytes) -> None:
        if self._seq_header_bytes == payload:
            return  # unchanged mid-stream repeat (schrodecoder.c:1155)
        if self._seq_header_bytes is not None:
            # format change: the old sequence's pictures drain first in
            # their own order, references are dropped
            self._drain_first += sorted(self._rob)
            self._rob = []
            self._core.refs.clear()
        self._seq_header_bytes = payload
        self._core.vf = bs.read_sequence_header(
            BitReader(payload)).video_format
        if not self.coded_order:
            # RoB sizing per schro_decoder_set_rob_size +1 headroom
            self._rob_size = (4 if self._core.vf.interlaced_coding
                              else 2) + 1

    def _maybe_skip(self, code: int, payload: bytes) -> bool:
        """Trick modes: decide from the picture header alone whether to
        skip decoding (schrodecoder.c:1325-1355)."""
        if bs.is_reference(code) or self._core.vf is None \
                or self._core.vf.interlaced_coding:
            return False
        num = int.from_bytes(payload[:4], "big")
        if num < self.earliest_frame:
            self.skipped.append(num)
            return True
        if self._skip_value > self.skip_ratio:
            self._skip_value *= (1 - _SKIP_TC)
            self.skipped.append(num)
            return True
        self._skip_value = self._skip_value * (1 - _SKIP_TC) + _SKIP_TC
        return False

    def _process(self) -> None:
        while True:
            got = self._sync.pull_unit()
            if got is None:
                return
            code, payload = got
            if code == bs.SEQUENCE_HEADER:
                self._adopt_sequence_header(payload)
            elif code == bs.END_OF_SEQUENCE:
                self.eos_seen = True
                self.flushing = True
            elif code == bs.AUXILIARY_DATA:
                if len(payload) >= 17 and payload[0] == 3:
                    self._core._pending_md5 = payload[1:17]
            elif bs.is_picture(code):
                if self._core.vf is None:
                    continue  # no sequence header yet: undecodable
                if self._maybe_skip(code, payload):
                    self._core._pending_md5 = None
                    continue
                try:
                    num, planes = self._core.decode_picture_unit(code,
                                                                 payload)
                except BrokenPicture as e:
                    self._core.errors.append({"code": code,
                                              "error": repr(e),
                                              "kind": e.kind})
                    self._core._pending_md5 = None
                    continue
                except (ValueError, KeyError, IndexError) as e:
                    self._core.errors.append({"code": code,
                                              "error": repr(e),
                                              "kind": "parse"})
                    self._core._pending_md5 = None
                    continue
                planes = tuple(pl.cpu().numpy() for pl in planes)
                if self._core._pending_md5 is not None:
                    if _native.frame_md5(planes) != self._core._pending_md5:
                        self._core.md5_failures.append(num)
                    self._core._pending_md5 = None
                self._rob.append((num, planes))

    # ---- pull side ----
    def pull(self):
        """Next picture in output order, or None (need more bits)."""
        if self._drain_first:
            return self._drain_first.pop(0)
        if not self._rob:
            return None
        if len(self._rob) >= self._rob_size or self.flushing:
            if self.coded_order:
                return self._rob.pop(0)
            i = min(range(len(self._rob)), key=lambda k: self._rob[k][0])
            return self._rob.pop(i)
        return None

    def pull_all(self) -> List[tuple]:
        """Drain everything currently pullable."""
        out = []
        while True:
            got = self.pull()
            if got is None:
                return out
            out.append(got)
