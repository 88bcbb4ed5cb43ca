"""The long-GOP encode cell's decoder: a frozen copy of the port's Dirac
stream decoder (`decoder/core.StreamDecoder` with what it needs: the
bitstream parser, the C++ arithmetic and motion-data decoding, the
inverse wavelets and the OBMC render), cut to 8-bit frames with
arithmetic-coded residuals.

It imports nothing of the program, so a change to the program cannot
change it; but it is the port's own decoding logic, not an independent
implementation of the Dirac specification.  Its pictures are judged
against the source frames the benchmark made, never against the
program's own output.  Its tensor work is plain PyTorch on the device of
the caller's choice, its bit-level decoding the copied C++ built with
g++ into `<checkout>/build/benchmark_refcodec/`.
"""
