"""ME full-pel SAD search: every full-pel search of the ME pyramid.

`me_search` is the entry point.  On CUDA tensors it launches the
hand-written kernel `csrc/patch_refine.cu` (the port of the Pallas kernel
`schroedinger_tpu/ops/pallas_me.py:71 make_patch_refine`), built with nvcc
at first use into `build/schroedinger_tpu_torch/` and bound with ctypes
(`ops/cuda_build.py`).
On CPU tensors it runs `me_search_plain`, the plain PyTorch version,
composed of the hint upsample, the block split, the edge-padded reference
and `patch_refine_plain` (the port of `schroedinger_tpu/encoder/me.py
_patch_refine`).  A CUDA tensor never takes the plain path: the wrapper
launches or raises.

Per ME block (i, j) of the (h / bs_y) x (w / bs_x) grid on the u8 level
planes `cur`, `ref`, it takes the hint clamp(scale * field[i*hy//nby,
j*hx//nbx], -bound, bound) (zero without a field or at scale 0), searches
the (2rad+1)^2 full-pel candidates around it in `ref` as edge-padded by
`margin` (window origins clamped into the padded plane as
jax.lax.dynamic_slice clamps), and returns the first minimum in (dy, dx)
order: mv (nby, nbx, 2) int32, which the next level takes as its field,
and sad (nby, nbx) int32.  A batch of N current planes `cur` (N, h, w)
with fields (N, hy, hx, 2) searches one shared reference in one launch
(the B pictures of a subgroup share their references) and returns mv
(N, nby, nbx, 2) and sad (N, nby, nbx).  The JAX ME's four uses:

  coarse scan    scale 0, rad = coarse radius   (me._dense_scan)
  hint refine    scale 2, rad 2, the parent's mv (upsample + _patch_refine)
  median SAD     scale 1, rad 0, the median field (sad_at(med))
  zero SAD       scale 0, rad 0                  (sad_zero)

The counter `me_search_launches` (`utils.telemetry.counters`) counts
kernel launches (and nothing else), so a run can show that its ME went
through the kernel.  `me_search_probe` launches one of the kernel's four
compile-time cost variants (the port of the TPU probe
`tools/profile_pk_parts.py:113`; see the source's head and
`tools/profile_patch_refine.py`); `me_probe_launches` counts those
launches.
"""
from __future__ import annotations

import os

import torch

from schroedinger_tpu_torch.ops import cuda_build
from schroedinger_tpu_torch.ops.obmc import _round8, extract_patches
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.utils.telemetry import counters

SOURCE = os.path.join(cuda_build.CSRC, "patch_refine.cu")

# the probe's variants, by their number in the source; only "full" gives
# right answers
PROBE_VARIANTS = ("full", "nostage", "nosad", "onewindow")


def to_blocks(c, nby, bs_y, nbx, bs_x):
    """(..., nby*bs_y, nbx*bs_x) -> (... * nb, bs_y, bs_x): the blocks of
    every leading plane, one after another."""
    return (c.reshape(*c.shape[:-2], nby, bs_y, nbx, bs_x).transpose(-3, -2)
            .reshape(-1, bs_y, bs_x))


def pad_ref(ref, margin):
    """Edge-clamp padded pel-grid reference: out[m+k, m+l] = ref[clip k,l]."""
    return pad_edge(ref, margin, margin, margin, margin)


def extract_ref_patches(P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad, margin):
    """Per-block (bs+2rad) patches of the padded ref at the block origin
    displaced by its MV (origins clamped into P).  mv_y, mv_x: (..., nby,
    nbx).  Returns (... * nb, ph, pw) int32 with ph, pw = round8(bs_y +
    2rad), round8(bs_x + 2rad)."""
    ph = _round8(bs_y + 2 * rad)
    pw = _round8(bs_x + 2 * rad)
    dev = P.device
    oy = ((torch.arange(nby, dtype=torch.int32, device=dev) * bs_y)[:, None]
          + mv_y - rad + margin).reshape(-1)
    ox = ((torch.arange(nbx, dtype=torch.int32, device=dev) * bs_x)[None, :]
          + mv_x - rad + margin).reshape(-1)
    return extract_patches(P, oy, ox, ph, pw).to(torch.int32)


def patch_refine_plain(cur_blocks, P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
                       margin):
    """(2rad+1)^2 full-pel refine around (mv_y, mv_x) via per-block patches
    of the padded reference (plain PyTorch; any device).

    cur_blocks: (... * nb, bs_y, bs_x) int32; P: (Hp, Wp) u8/int; mv_*:
    (..., nby, nbx) int32.  Returns (mv_y, mv_x, best_sad), each shaped
    as mv_y, int32."""
    pat = extract_ref_patches(P, mv_y, mv_x, nby, nbx, bs_y, bs_x, rad,
                              margin)
    K = 2 * rad + 1
    sads = [(cur_blocks - pat[:, a:a + bs_y, b:b + bs_x]).abs().sum(
        (1, 2), dtype=torch.int32) for a in range(K) for b in range(K)]
    s = torch.stack(sads)                        # (K*K, nb)
    best = torch.argmin(s, dim=0)                # first index on ties
    doy = (torch.div(best, K, rounding_mode="floor") - rad).to(torch.int32)
    dox = (best % K - rad).to(torch.int32)
    best_sad = torch.gather(s, 0, best[None])[0]
    return (mv_y + doy.reshape(mv_y.shape), mv_x + dox.reshape(mv_x.shape),
            best_sad.reshape(mv_y.shape))


def upsample_hint(field, nby, nbx, scale, bound, device):
    """The hints of an nby x nbx grid: clamp(scale * field[i*hy//nby,
    j*hx//nbx], -bound, bound), (nby, nbx, 2) int32; zeros without a
    field or at scale 0.  A field (N, hy, hx, 2) gives (N, nby, nbx, 2)."""
    if field is None or scale == 0:
        return torch.zeros((nby, nbx, 2), dtype=torch.int32, device=device)
    hy, hx = field.shape[-3], field.shape[-2]
    dev = field.device
    ys = torch.div(torch.arange(nby, device=dev) * hy, nby,
                   rounding_mode="floor")
    xs = torch.div(torch.arange(nbx, device=dev) * hx, nbx,
                   rounding_mode="floor")
    return (field[..., ys[:, None], xs[None, :], :] * scale).clamp(-bound,
                                                                   bound)


def me_search_plain(cur, ref, field, scale, bs_y, bs_x, rad, bound, margin):
    """me_search in plain PyTorch (any device): hint upsample, block
    split, padded reference, patch_refine_plain; a batch (N, h, w) is
    searched one picture after another.  Returns (mv, sad)."""
    if cur.ndim == 3:
        outs = [me_search_plain(cur[k], ref,
                                None if field is None else field[k], scale,
                                bs_y, bs_x, rad, bound, margin)
                for k in range(cur.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    h, w = cur.shape
    nby, nbx = h // bs_y, w // bs_x
    hint = upsample_hint(field, nby, nbx, scale, bound, cur.device)
    my, mx, sad = patch_refine_plain(
        to_blocks(cur.to(torch.int32), nby, bs_y, nbx, bs_x),
        pad_ref(ref, margin), hint[..., 0], hint[..., 1], nby, nbx, bs_y,
        bs_x, rad, margin)
    return torch.stack([my, mx], dim=-1), sad


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"me_search: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"me_search: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"me_search: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"me_search: {name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"me_search: {name} is not 16-byte aligned")


def _launch(variant, cur, ref, field, scale, bs_y, bs_x, rad, bound,
            margin):
    """Check the arguments and launch the kernel's variant of that number
    (0 = the search) on one picture (cur (h, w)) or a batch (cur (N, h, w),
    one launch).  Returns (mv, sad), views of one buffer."""
    dev = cur.device
    if dev.type != "cuda":
        raise ValueError(f"me_search: tensors on {dev}, expected cuda")
    if cur.ndim not in (2, 3):
        raise ValueError(f"me_search: cur must be (h, w) or (N, h, w), got "
                         f"{tuple(cur.shape)}")
    lead = tuple(cur.shape[:-2])
    n = lead[0] if lead else 1
    h, w = cur.shape[-2:]
    if h % bs_y or w % bs_x or h == 0 or w == 0 or n == 0:
        raise ValueError(f"me_search: plane {h}x{w} is not a whole grid of "
                         f"{bs_y}x{bs_x} blocks")
    if scale not in (0, 1, 2) or min(bs_y, bs_x) < 1 or rad < 0 \
            or bound < 0 or margin < 0:
        raise ValueError(f"me_search: scale {scale}, block {bs_y}x{bs_x}, "
                         f"rad {rad}, bound {bound}, margin {margin}")
    if (h + 2 * margin < _round8(bs_y + 2 * rad)
            or w + 2 * margin < _round8(bs_x + 2 * rad)):
        raise ValueError("me_search: padded plane smaller than one search "
                         "window")
    _check("cur", cur, torch.uint8, lead + (h, w), dev)
    _check("ref", ref, torch.uint8, (h, w), dev)
    hy = hx = 0
    if field is not None:
        if field.ndim != len(lead) + 3:
            raise ValueError(f"me_search: field must have {len(lead) + 3} "
                             f"dims, got {tuple(field.shape)}")
        hy, hx = field.shape[-3], field.shape[-2]
        _check("field", field, torch.int32, lead + (hy, hx, 2), dev)
        if hy == 0 or hx == 0:
            raise ValueError("me_search: empty field")
    nby, nbx = h // bs_y, w // bs_x
    nb = nby * nbx
    out = torch.empty(3 * n * nb, dtype=torch.int32, device=dev)
    err = cuda_build.load().me_search_launch(
        variant, n, cur.data_ptr(), ref.data_ptr(),
        None if field is None else field.data_ptr(), out.data_ptr(), h, w,
        hy, hx, scale, bs_y, bs_x, rad, bound, margin,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"me_search kernel launch failed: error {err}")
    return (out[:2 * n * nb].view(*lead, nby, nbx, 2),
            out[2 * n * nb:].view(*lead, nby, nbx))


def me_search(cur, ref, field, scale, bs_y, bs_x, rad, bound, margin):
    """Full-pel (2rad+1)^2 SAD search per block around its hint (see the
    module's head): (mv (nby, nbx, 2), sad (nby, nbx)), int32, with a
    leading N for a batch of current planes against the one reference.

    CUDA tensors launch the kernel, once for the whole batch (no plain
    fallback); CPU tensors run me_search_plain."""
    if cur.device.type == "cuda":
        outs = _launch(0, cur, ref, field, scale, bs_y, bs_x, rad, bound,
                       margin)
        counters.add("me_search_launches")
        return outs
    if cur.device.type != "cpu":
        raise ValueError(f"me_search: unsupported device {cur.device}")
    return me_search_plain(cur, ref, field, scale, bs_y, bs_x, rad, bound,
                           margin)


def launches() -> int:
    """me_search's kernel launches so far in this process (the counter
    `me_search_launches`)."""
    return counters.snapshot().get("me_search_launches", 0)


def probe_launches() -> int:
    """me_search_probe's launches so far in this process (the counter
    `me_probe_launches`)."""
    return counters.snapshot().get("me_probe_launches", 0)


def me_search_probe(variant: str, cur, ref, field, scale, bs_y, bs_x, rad,
                    bound, margin):
    """Launch one cost variant of the kernel (PROBE_VARIANTS) on CUDA
    tensors.  Same arguments and outputs as me_search; only "full"
    computes the search, the others exist to be timed."""
    outs = _launch(PROBE_VARIANTS.index(variant), cur, ref, field, scale,
                   bs_y, bs_x, rad, bound, margin)
    counters.add("me_probe_launches")
    return outs
