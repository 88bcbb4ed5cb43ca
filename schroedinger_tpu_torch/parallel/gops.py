"""GOP sharding: the outermost parallel axis.

Port of `schroedinger_tpu/parallel/gops.py`.  Every closed GOP (sequence
header, I picture and its P/B chain) is an independent unit of work, so
shards encode disjoint GOP-aligned chunks of a clip at once, and the
merge concatenates their payloads and rewrites the parse-offset chain.

Shard execution:
  * one process: a thread per shard (the device's work, the C++ entropy
    coder and numpy release the GIL, so shards overlap device and host
    work); the caches the shards share build once under locks;
  * a world of processes (`parallel/group.py`): one chunk range per rank,
    payload bytes gathered to every rank (`group.allgather_bytes`), so
    the merged stream is on every rank.

Byte-exactness: with content-adaptive state disabled across chunk
boundaries (scene-change scoring looks one frame back), the merged
stream is byte-identical to the serial encoder's.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, Tuple

import torch.distributed as dist

from schroedinger_tpu_torch import bitstream as bs
from schroedinger_tpu_torch.parallel import group


def chunk_ranges(n_frames: int, gop_length: int,
                 n_shards: int) -> List[Tuple[int, int]]:
    """Split [0, n_frames) into <= n_shards contiguous GOP-aligned ranges,
    balanced to within one GOP."""
    n_gops = -(-n_frames // gop_length)
    n_shards = max(1, min(n_shards, n_gops))
    per, extra = divmod(n_gops, n_shards)
    ranges = []
    g = 0
    for s in range(n_shards):
        take = per + (1 if s < extra else 0)
        start = g * gop_length
        stop = min((g + take) * gop_length, n_frames)
        if start < stop:
            ranges.append((start, stop))
        g += take
    return ranges


def _strip_units(stream: bytes) -> List[bytes]:
    """Re-split a shard stream into full parse units, dropping EOS."""
    units = []
    for code, payload in bs.split_units(stream):
        if code == bs.END_OF_SEQUENCE:
            continue
        units.append(b"BBCD" + bytes([code]) + b"\x00" * 8 + payload)
    return units


def merge_shard_streams(streams: Sequence[bytes]) -> bytes:
    """Concatenate per-shard streams into one valid Dirac stream: strips
    the shards' EOS units, rewrites the next/prev parse-offset chain
    across the whole sequence, and appends a single final EOS."""
    chain = bs.OffsetChain()
    out = bytearray()
    for s in streams:
        out += chain.add(_strip_units(s))
    out += chain.add([bs.make_eos_unit()], final_eos=True)
    return bytes(out)


def _validate_shard_encoder(enc, exact: bool = True) -> None:
    """exact=True: GOP sharding must be byte-exact vs the serial encode,
    which only the stateless fixed-qi IPPP configuration guarantees —
    scene change detection, CBR/quantiser engines, and the biref engine
    all carry cross-GOP state, so they are rejected up front.

    exact=False: any configuration is allowed — each chunk encodes as an
    independent self-contained sequence (fresh TM5 reservoir / engine
    state / scene-change history per chunk, the reference's quant_slot
    chain restarting at each chunk's first AU).  The merged stream is a
    valid CBR stream whose rate is held per chunk rather than across the
    whole sequence; it differs byte-wise from the serial encode exactly
    where that boundary state differs."""
    if not exact:
        return
    problems = []
    if getattr(enc, "enable_scene_change", False):
        problems.append("enable_scene_change")
    if getattr(enc, "rc", None) is not None:
        problems.append("bitrate/CBR")
    if getattr(enc, "qengine", None) is not None:
        problems.append("quantiser_engine")
    if getattr(enc, "gop_structure", "backref") != "backref":
        problems.append(f"gop_structure={enc.gop_structure}")
    if problems:
        raise ValueError(
            "Byte-exact GOP sharding requires a stateless fixed-qi IPPP "
            "encoder; unsupported options: " + ", ".join(problems)
            + " (pass exact=False for per-chunk-reservoir sharding)")


def _seed_shard_state(enc, start_frame: int) -> None:
    """Continue picture numbering and replicate the serial encoder's
    reference-retire counters at a GOP boundary: when the serial encoder
    reaches intra picture s it holds last_ref = s-1, prev_ref = s-2
    (IPPP; picture units include the field factor), and the opening intra
    retires prev_ref.  The shard encoder never touches those pictures'
    planes — only the numbers enter the bitstream — so seeding the
    counters makes the shard's units byte-identical to the serial ones."""
    ff = enc.field_factor
    s = start_frame * ff
    enc.frame_number = s
    if s >= 1:
        enc.last_ref = s - 1
    if s >= 2:
        enc.prev_ref = s - 2
    if s > 0:
        # stream-level aux units (codec comment/bitrate) belong to the
        # first shard only — the serial encoder emits them once
        enc._sent_stream_aux = True


def encode_gops_sharded(frames: Sequence, make_encoder: Callable[[], object],
                        n_shards: int, gop_length: int = None,
                        sequential: bool = False,
                        exact: bool = True) -> bytes:
    """Encode `frames` as n_shards independent GOP-aligned chunks.

    make_encoder() must return a fresh GopEncoder; its gop_length and
    field_factor are read off the first instance.  Picture numbering is
    made globally monotone by offsetting each shard's start number.
    One process: shards run on a thread pool (sequential=True codes them
    one after another).  exact=False allows CBR/engines/biref/scene-change
    configurations with per-chunk state (see _validate_shard_encoder).
    """
    proto = make_encoder()
    _validate_shard_encoder(proto, exact)
    gop_length = gop_length or proto.gop_length
    ranges = chunk_ranges(len(frames), gop_length, n_shards)

    def encode_one(rng_idx: int) -> bytes:
        start, stop = ranges[rng_idx]
        enc = proto if rng_idx == 0 else make_encoder()
        _seed_shard_state(enc, start)
        return enc.encode_stream(frames[start:stop])

    if sequential or len(ranges) == 1:
        shard_streams = [encode_one(i) for i in range(len(ranges))]
    else:
        with ThreadPoolExecutor(max_workers=len(ranges)) as ex:
            shard_streams = list(ex.map(encode_one, range(len(ranges))))
    return merge_shard_streams(shard_streams)


def encode_gops_multihost(frames: Sequence,
                          make_encoder: Callable[[], object],
                          gop_length: int = None,
                          shards_per_host: int = 1,
                          exact: bool = True) -> bytes:
    """The form for a world of processes: each rank of the default process
    group encodes its chunk range, then the payload bytes are gathered to
    every rank and merged.  Without a world, or in a world of one rank,
    it is encode_gops_sharded with shards_per_host threads.  exact=False
    allows the flagship CBR biref configuration with per-chunk
    reservoirs."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if n_proc == 1:
        return encode_gops_sharded(frames, make_encoder,
                                   n_shards=shards_per_host,
                                   gop_length=gop_length, exact=exact)
    proto = make_encoder()
    _validate_shard_encoder(proto, exact)
    gop_length = gop_length or proto.gop_length
    ranges = chunk_ranges(len(frames), gop_length, n_proc)
    rank = dist.get_rank()
    if rank < len(ranges):
        start, stop = ranges[rank]
        _seed_shard_state(proto, start)
        local = proto.encode_stream(frames[start:stop])
    else:
        local = b""
    return gather_and_merge(local, n_proc, group.allgather)


def gather_and_merge(local: bytes, n_proc: int, allgather) -> bytes:
    """The payload gather and byte-exact merge: variable-length shard
    streams travel as (length, zero-padded bytes) pairs through two
    allgathers (`group.allgather_bytes`), then the parse-offset chain is
    rewritten across the concatenation.  `allgather` is injectable, so
    the padding and unpacking are testable without a world."""
    streams = group.allgather_bytes(local, allgather)
    if len(streams) != n_proc:
        raise ValueError(f"gathered {len(streams)} payloads from a world "
                         f"of {n_proc}")
    return merge_shard_streams([s for s in streams if s])
