"""The long-GOP and main-intra settings that no other port test sets,
against the JAX package on the CPU at 96x80, byte for byte: pairs of
intra and inter wavelets in which all seven wavelets appear, on the
backref engine (each at a depth within its `MAX_DEPTH_S16` cap,
`slice_config.WAVELET_PAIRS`), main intra with Daubechies 9,7 at its
fixed quantiser (`BASELINE.json` config 2's codec setting), on the
biref engine the two magic lambda scales at the values of
`tests/test_settings.py`, and `transform_depth` 2 on the backref
engine.

Every stream goes through `api.Encoder` in both packages on the same
seeded frames and must be byte-equal; the port's `StreamDecoder` decodes
it to the JAX decoder's planes, with no picture error and no MD5
failure (MD5 is on).  The JAX side (encode and decode) of every case is
made once, on a module thread pool that starts with the first test and
works ahead of the next (XLA compiles release the GIL).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests import jax_cache  # noqa: F401 (turns the disk cache on)
from schroedinger_tpu import api as j_api
from schroedinger_tpu import config as j_config
from schroedinger_tpu.decoder import core as j_core
from schroedinger_tpu.video_format import ChromaFormat as JChroma
from schroedinger_tpu.video_format import VideoFormat as JVideoFormat
from schroedinger_tpu_torch import api as t_api
from schroedinger_tpu_torch import config as t_config
from schroedinger_tpu_torch.decoder import core as t_core
from schroedinger_tpu_torch.slice_config import (CONFIG_INTRA_DAUB97,
                                                 WAVELET_PAIRS, make_frames,
                                                 video_format)
from schroedinger_tpu_torch.wavelets import MAX_DEPTH_S16, Wavelet

torch.set_num_threads(1)

W, H = 96, 80
# biref: I, a one-reference P, three B pictures (with MD5 on, one at a
# time on the two-reference step)
N = 5
MD5 = dict(enable_md5=True)
# id -> (EncoderConfig keywords, frames); the backref streams code I, P, P
CASES = dict(
    {f"pair_{k}": (dict(kw, **MD5), 3) for k, kw in WAVELET_PAIRS.items()},
    main_intra_daubechies_9_7=(dict(CONFIG_INTRA_DAUB97, **MD5), 3),
    magic_subband0_lambda_scale=(dict(magic_subband0_lambda_scale=1000.0,
                                      **MD5), N),
    magic_chroma_lambda_scale=(dict(magic_chroma_lambda_scale=10.0, **MD5),
                               N),
    transform_depth_2=(dict(transform_depth=2, gop_structure="backref",
                            **MD5), 3),
)


def _jvf():
    return JVideoFormat(width=W, height=H, clean_width=W, clean_height=H,
                        chroma_format=JChroma.C420,
                        frame_rate_numerator=25, frame_rate_denominator=1)


# cases that compile the same JAX programs (the magic lambda scales are
# arguments of those programs) go on one thread, one after the other
SHARED = ("magic_subband0_lambda_scale", "magic_chroma_lambda_scale")


def _jax_cases(cases):
    """{case: (the JAX encoder's stream, the JAX decoder's planes of it,
    the decoder's errors and MD5 failures)}."""
    out = {}
    for case in cases:
        kw, n = CASES[case]
        stream = j_api.Encoder(_jvf(), j_config.EncoderConfig(
            **kw)).encode_stream(make_frames(n, W, H))
        dec = j_core.StreamDecoder()
        out[case] = (stream, dec.decode_stream(stream), dec.errors,
                     dec.md5_failures)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """{case: future of its group's `_jax_cases`}, the groups on threads
    that start with the first test that asks for them and work ahead of
    the next (XLA compiles release the GIL).  Three threads: with the
    compiled programs cached, what is left is Python tracing under the
    GIL, and more threads only delay the first case."""
    groups = [[c] for c in CASES if c not in SHARED] + [list(SHARED)]
    with ThreadPoolExecutor(3) as pool:
        jobs = {c: job for g in groups
                for job in [pool.submit(_jax_cases, g)] for c in g}
        yield jobs
        for job in jobs.values():
            job.cancel()


def test_pairs_cover_the_seven_wavelets_within_their_caps():
    seen = set()
    for kw in WAVELET_PAIRS.values():
        cfg = t_config.EncoderConfig(**kw)
        pair = tuple(Wavelet(cfg.enum_index(k))
                     for k in ("intra_wavelet", "inter_wavelet"))
        gop = t_api.Encoder(video_format(W, H), cfg, device="cpu")._gop
        assert (gop.intra_wavelet, gop.inter_wavelet) == pair
        assert gop.depth == min(kw["transform_depth"],
                                *(MAX_DEPTH_S16[w] for w in pair))
        seen.update(pair)
    assert seen == set(Wavelet)


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(jax_side, case):
    kw, n = CASES[case]
    frames = make_frames(n, W, H)
    enc = t_api.Encoder(video_format(W, H), t_config.EncoderConfig(**kw),
                        device="cpu")
    stream = enc.encode_stream(frames)
    dec = t_core.StreamDecoder(device="cpu")
    mine = dec.decode_stream(stream)
    j_stream, theirs, j_errors, j_md5 = jax_side[case].result()[case]
    print(f"{case}: port {len(stream)} bytes, JAX {len(j_stream)} bytes")
    assert stream == j_stream
    assert dec.errors == [] and dec.md5_failures == []
    assert j_errors == [] and j_md5 == []
    assert len(mine) == len(theirs) == n
    for x3, y3 in zip(mine, theirs):
        for x, y in zip(x3, y3):
            np.testing.assert_array_equal(x, np.asarray(y))
