"""Card-only checks of the port (marked `cuda`; they skip without a GPU).

The patch-refine CUDA kernel against its plain PyTorch version, and a
small stream encoded on the card against the CPU encode.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from schroedinger_tpu_torch.decoder.core import StreamDecoder
from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.encoder.gop import GopEncoder
from schroedinger_tpu_torch.ops import patch_refine as pr
from schroedinger_tpu_torch.slice_config import (CONFIG, make_frames,
                                                 video_format)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(rad, bs, flat, dev, nby=5, nbx=7, bound=24):
    margin = bound + 2 * rad + 16
    rng = np.random.default_rng(7 * rad + bs + 100 * flat)
    if flat:
        cur = np.full((nby * bs, nbx * bs), 77, np.uint8)
        ref = np.full((nby * bs, nbx * bs), 90, np.uint8)
    else:
        cur = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
        ref = rng.integers(0, 256, (nby * bs, nbx * bs)).astype(np.uint8)
    # hints run past the contract too: the window clamp must agree
    mvy = rng.integers(-bound - 8, bound + 9, (nby, nbx)).astype(np.int32)
    mvx = rng.integers(-bound - 8, bound + 9, (nby, nbx)).astype(np.int32)
    cb = me_mod._to_blocks(torch.tensor(cur, device=dev).to(torch.int32),
                           nby, bs, nbx, bs).contiguous()
    P = me_mod._pad_ref(torch.tensor(ref, device=dev), margin).contiguous()
    return (cb, P, torch.tensor(mvy, device=dev),
            torch.tensor(mvx, device=dev), nby, nbx, bs, bs, rad, margin)


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
@pytest.mark.parametrize("rad,bs", [(2, 4), (2, 8), (2, 16), (1, 16),
                                    (8, 4), (0, 16)])
def test_patch_refine_kernel_matches_plain(cuda_device, rad, bs, flat):
    args = _case(rad, bs, flat, cuda_device)
    before = pr.LAUNCHES
    got = pr.patch_refine(*args)
    assert pr.LAUNCHES == before + 1
    want = pr.patch_refine_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_patch_refine_rejects_bad_inputs(cuda_device):
    args = list(_case(2, 8, False, cuda_device))
    bad_dtype = list(args)
    bad_dtype[1] = args[1].to(torch.int32)          # P must be u8
    with pytest.raises(TypeError):
        pr.patch_refine(*bad_dtype)
    bad_layout = list(args)
    bad_layout[2] = torch.stack([args[2], args[3]], -1)[..., 0]
    with pytest.raises(ValueError):
        pr.patch_refine(*bad_layout)


@pytest.mark.cuda
def test_small_stream_on_card_equals_cpu(cuda_device):
    frames = make_frames(4, 128, 64)
    vf = video_format(128, 64)
    before = pr.LAUNCHES
    s_gpu = GopEncoder(vf, device=cuda_device,
                       **CONFIG).encode_stream(frames)
    assert pr.LAUNCHES > before
    s_cpu = GopEncoder(vf, device="cpu", **CONFIG).encode_stream(frames)
    assert s_gpu == s_cpu
    dec = StreamDecoder(device=cuda_device)
    out = dec.decode_stream(s_gpu)
    assert len(out) == 4 and dec.md5_failures == [] and dec.errors == []
