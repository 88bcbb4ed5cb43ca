"""Check and timing of the ME's final stage CUDA kernel (kernel #4), on one
NVIDIA GPU.

    python -m schroedinger_tpu_torch.tools.profile_me_final

At the main path's launch shapes (SHAPES: a 1080p reference of one
picture and of a batch of three B pictures, as the long-GOP encode's P
steps and B batches launch it at quarter pel with the competition; a
batch of three 1080i field pictures; a batch of three 2160p pictures),
on pan + noise content (`slice_config.make_frames`) whose vectors and
SADs come from the ME's own pyramid (`make_inputs`), it holds the kernel
(`ops/me_final.py me_final`) to the plain version (`me_final_plain`) with
torch.equal on (dy, dx, sad), then times the kernel on the device alone
(20 launches captured in one CUDA graph and replayed) and from Python as
the encoder launches it, and the plain version from Python, beside the
least time the card could take (`bound_ms`), and prints one line per
shape with the card's name and power limit.

It needs the card and raises without one.
"""
from __future__ import annotations

import torch

from schroedinger_tpu_torch.encoder import me as me_mod
from schroedinger_tpu_torch.ops import me_final as mf
from schroedinger_tpu_torch.ops import obmc
from schroedinger_tpu_torch.ops.pad import pad_edge
from schroedinger_tpu_torch.slice_config import make_frames
from schroedinger_tpu_torch.tools.profile_patch_refine import (
    ALU_OPS_PER_S, COARSE_RADIUS, HBM_BYTES_PER_S, gpu_line, graph_ms,
    time_ms)

# (picture width, height, pictures against the reference, block size,
# precision): the ME's final stage of one reference
SHAPES = {
    "1080p N=1": (1920, 1080, 1, 16, 2),
    "1080p N=3": (1920, 1080, 3, 16, 2),
    "1080i field N=3": (1920, 540, 3, 16, 2),
    "2160p N=3": (3840, 2160, 3, 16, 2),
}
MAIN_SHAPES = ("1080p N=1", "1080p N=3")
MARGIN = me_mod.ME_BOUND_PEL + 2 * COARSE_RADIUS + 16
# operations of one absolute difference (subtract, absolute, add) and of
# one bilinear sample with a nonzero fraction (four multiplies, three
# adds, the rounding add and the shift)
OPS_PER_DIFF = 3
OPS_PER_TAP = 9


def make_inputs(name, dev, seed=0):
    """me_final's arguments at one of SHAPES: pan + noise pictures (the
    numpy seed `seed`), the reference's half-pel plane, and the vectors
    and SADs of the ME's pyramid (make_me_body without candidates)."""
    w, h, n, bs, prec = SHAPES[name]
    frames = make_frames(n + 1, w, h, seed=seed)
    ref = torch.tensor(frames[0][0], device=dev)
    cur = torch.stack([torch.tensor(f[0], device=dev) for f in frames[1:]])
    nbx, nby = 4 * -(-w // (4 * bs)), 4 * -(-h // (4 * bs))
    dy, dx, sad = me_mod.make_me_body(h, w, bs, bs, nbx, nby, levels=5,
                                      coarse_radius=COARSE_RADIUS,
                                      candidates=False)(cur, ref)
    c = pad_edge(cur, 0, nby * bs - h, 0, nbx * bs - w).contiguous()
    r = pad_edge(ref, 0, nby * bs - h, 0, nbx * bs - w).contiguous()
    up = obmc.make_halfpel(obmc.upsample_plane(ref))
    return (c, r, up, torch.stack([dy, dx], -1).contiguous(),
            sad.contiguous(), bs, bs, prec, True, True, me_mod.ME_BOUND_PEL,
            MARGIN)


def bound_ms(args):
    """The least time the card could take for one me_final call: the
    operations the stage needs (the competition's SADs at the median and
    at zero, the nine candidates of each precision level, counting the
    bilinear taps only where a fraction is nonzero: none at level 1,
    eight of nine candidates above) over the ALU rate, against the bytes
    it needs once (the current planes, the level-0 reference and the
    half-pel plane where read, the vectors and SADs in, dy, dx and sad
    out) over the memory rate.  Returns (ms, "operations" or "bytes")."""
    c, r, up, mv, sad, bs_y, bs_x, prec, compete, zero_cand = args[:10]
    n, ph, pw = c.shape
    nb = (ph // bs_y) * (pw // bs_x)
    px = n * nb * bs_y * bs_x
    ops = (2 if zero_cand else 1) * px * OPS_PER_DIFF if compete else 0
    for level in range(1, prec + 1):
        ops += 9 * px * OPS_PER_DIFF + (8 * px * OPS_PER_TAP if level > 1
                                        else 0)
    nbytes = c.numel() + mv.numel() * 4 + 3 * n * nb * 4
    if compete:
        nbytes += r.numel() + sad.numel() * 4
    if prec:
        nbytes += up.numel()
    t_ops, t_bytes = ops / ALU_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check(args):
    """The kernel against the plain version on the card: (dy, dx, sad)
    equal, one launch counted per call."""
    before = mf.launches()
    got = mf.me_final(*args)
    want = mf.me_final_plain(*args)
    torch.cuda.synchronize()
    if mf.launches() != before + 1:
        raise AssertionError(f"me_final: {mf.launches() - before} launches "
                             "for 1 call")
    for g, w_, name in zip(got, want, ("dy", "dx", "sad")):
        if g.dtype != torch.int32 or not torch.equal(g, w_):
            raise AssertionError(f"me_final: {name} differs from the plain "
                                 "version")
    return got


def profile_shape(name, dev, card, seed=0):
    """Check and time one of SHAPES; prints its line and returns
    {"device_ms", "python_ms", "plain_ms", "bound_ms", "bound_by"}."""
    args = make_inputs(name, dev, seed)
    got = check(args)
    moved = int((got[0] != args[3][..., 0] << args[7]).sum())
    device = graph_ms(mf.me_final, args)
    python = time_ms(mf.me_final, args)
    plain = time_ms(mf.me_final_plain, args, iters=3, warmups=1)
    bound, by = bound_ms(args)
    c = args[0]
    print(f"me_final {name} ({c.shape[0]} x {c.shape[1]}x{c.shape[2]}, "
          f"blocks {args[5]}x{args[6]}, precision {args[7]}): kernel == "
          f"plain ({moved} of {got[0].numel()} vertical components moved "
          f"by the stage); device {device:.4f} ms, from Python "
          f"{python:.4f} ms, plain from Python {plain:.3f} ms, bound "
          f"{bound:.4f} ms by {by} ({bound / device:.1%} of it) [{card}]",
          flush=True)
    return {"device_ms": device, "python_ms": python, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU: the ME's final stage "
                           "kernel has no CPU mode")
    card = gpu_line()
    dev = torch.device("cuda")
    for name in SHAPES:
        profile_shape(name, dev, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
