"""Dead-zone quantiser / dequantiser, bit-exact with the reference.

Port of `schroedinger_tpu/ops/quant.py`.  Reference semantics
(schroutils.c:177-235):

  dequantise(q) = sign(q) * ((|q| * qf + qo + 2) >> 2)          (0 -> 0)
  quantise(v):   x = |v| << 2
                 0 if x < qo (dead zone)
                 else sign(v) * ((x - (qo - qf//2)) / qf)       (trunc div)

All intermediates are C `int` (32-bit, wrapping).  Torch leaves signed
int32 overflow to C++, so every step that can leave the int32 range runs
in int64 and is wrapped back to int32 explicitly (`wrap32`), which gives
the same bits as the wrapping int32 arithmetic of the JAX version.
"""
import torch

from schroedinger_tpu_torch import tables


def wrap32(x):
    """int64 tensor -> int32 tensor with two's-complement wrap."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def quant_factor(qi, device=None):
    return torch.as_tensor(tables.QUANT_FACTOR, dtype=torch.int32,
                           device=device)[qi]


def quant_offset(qi, intra: bool, device=None):
    t = tables.QUANT_OFFSET_1_2 if intra else tables.QUANT_OFFSET_3_8
    return torch.as_tensor(t, dtype=torch.int32, device=device)[qi]


def _as_i64(a, device):
    return torch.as_tensor(a, device=device).to(torch.int64)


def quantise(v, qf, qo):
    """Vectorized dead-zone quantise. v int tensor; qf/qo broadcastable.

    Returns int32 quantised magnitudes with sign."""
    v = wrap32(v.to(torch.int64)).to(torch.int64)
    qf = _as_i64(qf, v.device)
    qo = _as_i64(qo, v.device)
    x = wrap32(v.abs() << 2).to(torch.int64)
    offset = qo - torch.div(qf, 2, rounding_mode="floor")
    # numerator >= qf//2 >= 0 whenever x >= qo, so trunc == floor division
    num = wrap32(x - offset).to(torch.int64)
    mag = torch.where(x < qo, torch.zeros_like(x),
                      torch.div(num, qf.clamp(min=1), rounding_mode="floor"))
    return wrap32(torch.where(v < 0, -mag, mag))


def dequantise(q, qf, qo):
    """Vectorized dequantise; int32 wrapping as the C `int` path."""
    q = wrap32(q.to(torch.int64)).to(torch.int64)
    qf = _as_i64(qf, q.device)
    qo = _as_i64(qo, q.device)
    mag = (wrap32(q.abs() * qf + qo + 2) >> 2).to(torch.int64)
    out = torch.where(q < 0, -mag, mag)
    return wrap32(torch.where(q == 0, torch.zeros_like(out), out))

