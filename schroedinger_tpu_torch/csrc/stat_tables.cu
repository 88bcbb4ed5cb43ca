// The 61-way stat-table sums for Hopper (sm_90a): the three (N, 61, ncol)
// sums behind the rate control's per-(component, band) bits and error
// tables, in one read of the coefficients.
//
// Replaces no TPU kernel: the JAX package leaves these tables to XLA
// (schroedinger_tpu/encoder/ratecontrol.py band_counts).  It was added
// because the port's plain PyTorch pass (encoder/ratecontrol.py
// band_counts_plain) evaluated all 61 quant indices in chunks of
// (N, chunk, n) int32, bool and float32 temporaries in device memory, some
// 25 ms of kernels a 1080p frame, on the frame's critical path.
//
// What it computes, for every picture p < N, quant index q < 61 and
// column c < ncol, over the coefficients v of each slice (c, lo, hi) of
// the bounds list (slices may overlap and columns repeat), exactly as the
// plain path does:
//
//   x    = 4|v|
//   mag  = x < qo ? 0 : floor((x - qo + qf/2) / qf)        (dead zone)
//   dmag = mag ? (mag * qf + qo + 2) >> 2 : 0               (dequantise)
//   mag  sum of 2 * bitlen(mag + 1) - 1 over the nonzero mag (int64)
//   nz   count of the nonzero mag (int64)
//   err  float64 sum of the float32 terms | |v| - dmag | ** power
//
// with (qf, qo) the quant factor and the intra or inter offset of index
// q.  The division is a multiply by a per-index magic number and a shift
// (the host's table; ops/stat_tables.py quant_constants, checked there
// against floor division for every index over every |v| < 2^24): exact
// while x - qo + qf/2 < 2^27, which holds for every |v| < 2^24.
// Integral powers 1-16 take the square-and-multiply order of
// ratecontrol.error_metric, so the float32 terms are the same bits; other
// powers go through powf.  The integer sums are exact; err differs from
// the plain path's only by the order of its float64 additions, and every
// sum is taken in a fixed order, so two runs give the same bits.
//
// What bounds it on this card.  One 1080p 4:2:0 picture is 3.13 M
// coefficients (6.3 MB as int16, read once, well inside the 50 MB L2)
// and 191 M (coefficient, index) evaluations of about twenty integer and
// float operations: operations bind, by some 20x over bytes.  What the
// design does:
//  * Each coefficient is read once, 16 bytes a thread, into registers:
//    a thread holds 16 |v| and runs the 61 indices over them from
//    registers; the index constants sit in shared memory.  No (N, chunk,
//    n) temporaries: the only traffic is the input and the partials.
//  * Tiles.  A block (128 threads) takes 2048 coefficients of one slice
//    of one picture, so its sums belong to one column; a 1080p picture
//    is about 1530 blocks, enough to fill 132 SMs at N = 1, and a batch
//    of N pictures is the grid's second dimension.  A tile's window is
//    aligned to 16 bytes; the coefficients of the window outside the
//    slice are read as 0, which adds nothing (0 quantises to 0 at every
//    index and its error term is 0 for every power > 0; powf's path masks
//    them).
//  * Per index, the nonzero count and the magnitude bits of a thread are
//    one packed 32-bit sum ((bits << 10) + count), summed over the warp by
//    one redux.sync; the float64 error by a fixed butterfly of shuffles.
//    Lane 0 keeps the warp's sums in shared memory, and the block's 61
//    partials go to device memory.
//  * A second, small kernel sums each column's partials in a fixed order
//    (eight strided runs over the column's tiles, then the eight in turn)
//    and writes the three tables.  No float atomics anywhere.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 61;                           // quant indices
constexpr int kThreads = 128;                    // threads of a pass-1 block
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                   // coefficients a thread holds
constexpr int kTile = kThreads * kPerThread;     // coefficients of a block
constexpr int kRuns = 8;                         // strided runs of pass 2
constexpr int kReduceThreads = 64 * kRuns;       // 64 >= kQ lanes a run

// the error term's power: a compile-time square-and-multiply for power
// 4, the default error power (on an H100 some 1.36x faster at the 1080p
// shapes than the run-time one), a run-time one for the other integral
// powers 1-16, powf for the rest
constexpr int kPowRuntime = 0;
constexpr int kPowFloat = -1;

// ratecontrol.error_metric's order: out takes the squares of the set
// bits from the lowest up; 1 * sq is sq exactly, and __fmul_rn keeps the
// products from being contracted or reordered.
__device__ __forceinline__ float pow_int(float ad, int n) {
  float out = 1.0f;
  float sq = ad;
#pragma unroll
  for (int i = 0; i < 5; ++i) {                  // n <= 16 has 5 bits
    if (n & 1) out = __fmul_rn(out, sq);
    n >>= 1;
    if (n) sq = __fmul_rn(sq, sq);
  }
  return out;
}

template <int kPow>
__device__ __forceinline__ float error_term(float ad, int ip, float power) {
  if constexpr (kPow > 0) return pow_int(ad, kPow);
  else if constexpr (kPow == kPowRuntime) return pow_int(ad, ip);
  else return powf(ad, power);
}

// 16 bytes of T at p (16-byte aligned) as T values
template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&out)[16 / sizeof(T)]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) out[i] = t[i];
}

// Pass 1: one block per (tile, picture).  tiles holds (lo, hi, k) per
// tile: the slice [lo, hi) of a picture's n coefficients and the tile's
// number within it.  Writes the block's 61 (bits, count) and error sums.
template <typename T, int kPow>
__global__ void __launch_bounds__(kThreads)
stat_tables_partials(const T* __restrict__ v, long long n,
                     const int* __restrict__ qtab,
                     const int* __restrict__ tiles, int ntiles, int ip,
                     float power, int2* __restrict__ part_bits,
                     double* __restrict__ part_err) {
  constexpr int V = 16 / sizeof(T);              // coefficients a load
  __shared__ int s_q[kQ * 4];
  __shared__ unsigned s_packed[kWarps][kQ];
  __shared__ double s_err[kWarps][kQ];

  const int tile = blockIdx.x;
  const int pic = blockIdx.y;
  for (int i = threadIdx.x; i < kQ * 4; i += kThreads) s_q[i] = qtab[i];
  const long long row = static_cast<long long>(pic) * n;
  const long long g_lo = row + tiles[3 * tile];
  const long long g_hi = row + tiles[3 * tile + 1];
  const long long t0 =
      (g_lo & ~static_cast<long long>(V - 1)) +
      static_cast<long long>(tiles[3 * tile + 2]) * kTile;

  // |v| of the thread's 16 coefficients (0 outside the slice); a load
  // is made only where its 16 bytes meet the slice, so it stays inside
  // the 16-byte block of the tensor's last coefficient
  unsigned a[kPerThread];
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < kPerThread / V; ++j) {
    const long long c0 =
        t0 + static_cast<long long>(threadIdx.x + j * kThreads) * V;
    T vals[V];
#pragma unroll
    for (int i = 0; i < V; ++i) vals[i] = 0;
    if (c0 < g_hi && c0 + V > g_lo) load16(v + c0, vals);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool ok = c0 + i >= g_lo && c0 + i < g_hi;
      a[j * V + i] =
          ok ? static_cast<unsigned>(abs(static_cast<int>(vals[i]))) : 0u;
      valid |= static_cast<unsigned>(ok) << (j * V + i);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < kQ; ++q) {
    const int qf = s_q[4 * q];
    const unsigned qo = static_cast<unsigned>(s_q[4 * q + 1]);
    const unsigned magic = static_cast<unsigned>(s_q[4 * q + 2]);
    const int shift = s_q[4 * q + 3];
    // x - qo + qf/2, wrapping where x < qo (those are masked)
    const unsigned bias = static_cast<unsigned>((qf >> 1)) - qo;
    unsigned packed = 0;
    double err = 0.0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const unsigned x = a[e] << 2;
      unsigned mag = __umulhi(x + bias, magic) >> shift;
      mag = x < qo ? 0u : mag;
      const unsigned dmag = mag ? (mag * qf + qo + 2u) >> 2 : 0u;
      const float ad = static_cast<float>(abs(static_cast<int>(a[e] - dmag)));
      float t = error_term<kPow>(ad, ip, power);
      if constexpr (kPow == kPowFloat) t = (valid >> e) & 1u ? t : 0.0f;
      err = __dadd_rn(err, static_cast<double>(t));
      const unsigned bits = 63u - 2u * static_cast<unsigned>(__clz(mag + 1u));
      packed += mag ? (bits << 10) + 1u : 0u;
    }
    packed = __reduce_add_sync(0xffffffffu, packed);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      err = __dadd_rn(err, __shfl_xor_sync(0xffffffffu, err, o));
    if (lane == 0) {
      s_packed[warp][q] = packed;
      s_err[warp][q] = err;
    }
  }
  __syncthreads();
  if (threadIdx.x < kQ) {
    const int q = threadIdx.x;
    int bits = 0, nz = 0;
    double err = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      bits += static_cast<int>(s_packed[w][q] >> 10);
      nz += static_cast<int>(s_packed[w][q] & 1023u);
      err = __dadd_rn(err, s_err[w][q]);
    }
    const size_t at = (static_cast<size_t>(pic) * ntiles + tile) * kQ + q;
    part_bits[at] = make_int2(bits, nz);
    part_err[at] = err;
  }
}

// Pass 2: one block per (column, picture).  col_ptr / col_segs list the
// column's slices in bounds order, each as its tiles [first, end).  Run r
// of a quant index sums the column's tiles r, r + 8, r + 16, ... in
// order; then the eight runs are added in turn.
__global__ void __launch_bounds__(kReduceThreads)
stat_tables_reduce(const int2* __restrict__ part_bits,
                   const double* __restrict__ part_err, int ntiles,
                   const int* __restrict__ col_ptr,
                   const int* __restrict__ col_segs, int ncol,
                   long long* __restrict__ mag, long long* __restrict__ nz,
                   double* __restrict__ err) {
  __shared__ long long s_mag[kRuns][64];
  __shared__ long long s_nz[kRuns][64];
  __shared__ double s_err[kRuns][64];
  const int col = blockIdx.x;
  const int pic = blockIdx.y;
  const int q = threadIdx.x & 63;
  const int r = threadIdx.x >> 6;
  long long b = 0, z = 0;
  double e = 0.0;
  if (q < kQ) {
    int seen = 0;                                // tiles of earlier slices
    for (int s = col_ptr[col]; s < col_ptr[col + 1]; ++s) {
      const int first = col_segs[2 * s];
      const int end = col_segs[2 * s + 1];
      const int skip = ((r - seen) % kRuns + kRuns) % kRuns;
      for (int t = first + skip; t < end; t += kRuns) {
        const size_t at = (static_cast<size_t>(pic) * ntiles + t) * kQ + q;
        const int2 bz = part_bits[at];
        b += bz.x;
        z += bz.y;
        e = __dadd_rn(e, part_err[at]);
      }
      seen += end - first;
    }
  }
  s_mag[r][q] = b;
  s_nz[r][q] = z;
  s_err[r][q] = e;
  __syncthreads();
  if (r == 0 && q < kQ) {
#pragma unroll
    for (int i = 1; i < kRuns; ++i) {
      b += s_mag[i][q];
      z += s_nz[i][q];
      e = __dadd_rn(e, s_err[i][q]);
    }
    const size_t o = (static_cast<size_t>(pic) * kQ + q) * ncol + col;
    mag[o] = b;
    nz[o] = z;
    err[o] = e;
  }
}

template <typename T>
int launch_partials(int pow_mode, int ip, float power, int n_pics,
                    long long n, const void* v, const int* qtab,
                    const int* tiles, int ntiles, int2* part_bits,
                    double* part_err, cudaStream_t st) {
  void (*kernel)(const T*, long long, const int*, const int*, int, int,
                 float, int2*, double*);
  switch (pow_mode) {
    case 4: kernel = stat_tables_partials<T, 4>; break;
    case kPowRuntime: kernel = stat_tables_partials<T, kPowRuntime>; break;
    case kPowFloat: kernel = stat_tables_partials<T, kPowFloat>; break;
    default: return -1;
  }
  kernel<<<dim3(ntiles, n_pics), kThreads, 0, st>>>(
      static_cast<const T*>(v), n, qtab, tiles, ntiles, ip, power, part_bits,
      part_err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem_bytes: 2 (int16) or 4 (int32) coefficients, v (n_pics, n) with a
// 16-byte aligned start; pow_mode: 4 (power 4, compiled), 0 (the
// integral power ip, 1-16), -1 (powf(., power)); qtab (61, 4) int32: qf,
// qo, magic, shift; tiles (ntiles, 3) int32; col_ptr (ncol + 1) and
// col_segs (slices, 2) int32; part_bits (n_pics, ntiles, 61) int2 and
// part_err (n_pics, ntiles, 61) float64 scratch; mag, nz (n_pics, 61,
// ncol) int64 and err (n_pics, 61, ncol) float64 out.  Returns
// cudaGetLastError() after each launch (0 = both launched), -1 for an
// unknown type or power mode, -3 for a grid the card cannot launch.
extern "C" int stat_tables_launch(int elem_bytes, int pow_mode, int ip,
                                  float power, int n_pics, long long n,
                                  const void* v, const void* qtab,
                                  const void* tiles, int ntiles,
                                  const void* col_ptr, const void* col_segs,
                                  int ncol, void* part_bits, void* part_err,
                                  void* mag, void* nz, void* err,
                                  void* stream) {
  if (n_pics <= 0 || ncol <= 0) return 0;
  if (n_pics > 65535) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* pb = static_cast<int2*>(part_bits);
  double* pe = static_cast<double*>(part_err);
  if (ntiles > 0) {
    const int* qt = static_cast<const int*>(qtab);
    const int* ti = static_cast<const int*>(tiles);
    int rc;
    if (elem_bytes == 2)
      rc = launch_partials<int16_t>(pow_mode, ip, power, n_pics, n, v, qt, ti,
                                    ntiles, pb, pe, st);
    else if (elem_bytes == 4)
      rc = launch_partials<int32_t>(pow_mode, ip, power, n_pics, n, v, qt, ti,
                                    ntiles, pb, pe, st);
    else
      return -1;
    if (rc != 0) return rc;
  }
  stat_tables_reduce<<<dim3(ncol, n_pics), kReduceThreads, 0, st>>>(
      pb, pe, ntiles, static_cast<const int*>(col_ptr),
      static_cast<const int*>(col_segs), ncol, static_cast<long long*>(mag),
      static_cast<long long*>(nz), static_cast<double*>(err));
  return static_cast<int>(cudaGetLastError());
}
