"""Dirac intra picture encoder (fixed quantiser path).

Port of `schroedinger_tpu/encoder/intra.py` `encode_picture`: the forward
wavelet runs on the device of the caller's choice; subband quantisation
with per-codeblock quant indices and the entropy coding run on the host
(the shared native C++ coder).  The fused stat-table step of the JAX
package (`encode_picture_fused`) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from schroedinger_tpu.bitstream import (BitWriter, parse_code_picture,
                                        write_parse_info, write_picture_header,
                                        write_transform_parameters)
from schroedinger_tpu.coding import subband as sb
from schroedinger_tpu.params import Params, subband_count, subband_position
from schroedinger_tpu_torch.coding import slices as sl
from schroedinger_tpu_torch.decoder.lowdelay import _inverse, _to_u8
from schroedinger_tpu_torch.encoder.lowdelay import _forward, _prep_plane


def _codeblock_counts(p: Params, index: int):
    position = subband_position(index)
    if index == 0:
        return p.horiz_codeblocks[0], p.vert_codeblocks[0]
    level = position >> 2
    return p.horiz_codeblocks[level + 1], p.vert_codeblocks[level + 1]


def encode_picture(planes_u8, p: Params, frame_number: int,
                   quant_indices=None, is_ref: bool = False,
                   retired: int | None = None,
                   return_recon: bool = False, device="cpu"):
    """Encode one intra picture; quant_indices: None (all zero:
    lossless), an int, or a map (component, subband) -> (vcb, hcb) array.

    planes_u8: three u8 planes (numpy arrays or tensors).  With
    return_recon the decoder-exact reconstruction comes back as three u8
    tensors on `device`."""
    if p.video_format.bit_depth != 8:
        raise NotImplementedError("deep (>8-bit) intra coding is not ported")
    if p.is_noarith:
        raise NotImplementedError("no-arith intra coding is not ported")
    depth = p.transform_depth
    nb = subband_count(depth)
    iwt_dims = [(p.iwt_luma_height, p.iwt_luma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width),
                (p.iwt_chroma_height, p.iwt_chroma_width)]
    pic_sizes = [p.video_format.picture_luma_size(),
                 p.video_format.picture_chroma_size(),
                 p.video_format.picture_chroma_size()]

    w = BitWriter()
    write_parse_info(w, parse_code_picture(is_ref, 0, False, False))
    retired_delta = None
    if is_ref:
        retired_delta = 0 if retired is None else retired - frame_number
    write_picture_header(w, frame_number, retired_delta=retired_delta)
    w.sync()
    write_transform_parameters(w, p)
    w.sync()

    recon_planes = []
    for comp, (plane, (oh, ow)) in enumerate(zip(planes_u8, iwt_dims)):
        plane = (plane.to(device) if torch.is_tensor(plane) else
                 torch.tensor(np.asarray(plane, np.uint8), device=device))
        pyr = _forward(_prep_plane(plane, oh, ow), depth,
                       p.wavelet_filter_index)
        bands = [b.cpu().numpy().astype(np.int64)
                 for b in sl.subband_arrays(pyr, depth)]

        deq_bands = [None] * nb
        for index in range(nb):
            hcb, vcb = _codeblock_counts(p, index)
            position = subband_position(index)
            if quant_indices is None:
                qi_arr = np.zeros((vcb, hcb), dtype=np.int32)
            elif np.isscalar(quant_indices):
                qi_arr = np.full((vcb, hcb), int(quant_indices), np.int32)
            else:
                qi_arr = np.asarray(quant_indices[(comp, index)], np.int32)

            qdata, deq = sb.quantise_subband(
                bands[index], qi_arr, position, hcb, vcb,
                is_intra=(p.num_refs == 0))
            deq_bands[index] = deq

            w.sync()
            if not np.any(qdata):
                w.write_uint(0)
                continue
            parent_deq = deq_bands[index - 3] if position >= 4 else None
            with record_function("encode_subband_arith"):
                payload, first_qi = sb.encode_subband_arith(
                    qdata, parent_deq, position, hcb, vcb,
                    p.codeblock_mode_index == 1, qi_arr)
            w.write_uint(len(payload))
            if first_qi == -1:
                first_qi = int(qi_arr[0, 0])
            if len(payload) > 0:
                w.write_uint(first_qi)
                w.sync()
                w.write_bytes(bytes(payload))
        if return_recon:
            rpyr = sl.arrays_to_pyramid(
                [torch.as_tensor(np.asarray(b, dtype=np.int16), device=device)
                 for b in deq_bands], depth)
            rplane = _inverse(rpyr, p.wavelet_filter_index)
            (w_pic, h_pic) = pic_sizes[comp]
            recon_planes.append(_to_u8(rplane, h_pic, w_pic))
    w.sync()
    if return_recon:
        return w.get_bytes(), tuple(recon_planes)
    return w.get_bytes()
