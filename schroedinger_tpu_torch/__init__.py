"""schroedinger_tpu_torch — the Dirac / VC-2 codec in PyTorch for CUDA.

A port of `schroedinger_tpu` (the JAX reference package) to PyTorch, with
the ME's full-pel search (`ops/patch_refine.me_search`) as a hand-written
CUDA kernel for Hopper (`csrc/patch_refine.cu`).  Module paths mirror the JAX package's.  The
port keeps its own copy of that package's host modules (params, tables,
bitstream, the C++ arith/VLC/MV coder and MD5 under `coding/native/`).

This package imports `torch`, never `jax` and nothing of the JAX package.
Every tensor function runs on the device of its inputs; the entry points
(`api.Encoder`, `api.Decoder`, `encoder.gop.GopEncoder`, the decoders,
`tools/schro_tpu.py`) take a `device` and run on the card unless the
caller asks for the CPU.
"""

__version__ = "0.2.0"


def clear_compiled_caches():
    """Drop every module-level cache of built steps: the inter step (which
    serves single pictures and batches of B pictures alike), the phase
    correlation of each picture size, the fused intra step, the low-delay analysis and the pipelined decoder's steps.
    The counterpart of `schroedinger_tpu.clear_compiled_caches`, which
    leaves the JAX package's B-batch programs alive."""
    from schroedinger_tpu_torch.decoder import pipeline
    from schroedinger_tpu_torch.encoder import inter, intra, lowdelay

    inter._STEP_CACHE.clear()
    inter._PHASECORR_FNS.clear()
    intra._I_STEP_CACHE.clear()
    pipeline._DEC_CACHE.clear()
    lowdelay._ANALYZE_CACHE.clear()
    lowdelay._HOST_CACHE.clear()
