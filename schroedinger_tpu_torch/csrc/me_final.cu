// The ME pass's final stage for Hopper (sm_90a): the candidate competition
// and the subpel refine of every ME block in one launch (kernel #4).
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA
// (schroedinger_tpu/encoder/me.py, make_me_body's final-level competition
// and make_subpel_body).  Written because its plain PyTorch version
// (ops/me_final.py me_final_plain) dispatched about 520 small ops for each
// reference an inter picture searches (the median field's nine gathers
// and sort, two more kernel #1 launches, the stacks and argmins, and per
// precision level nine bilinear candidates built from strided slices of
// an int32 patch tensor): the largest share of the host's work under
// `me_pass`, the largest idle gap of the long-GOP encode, and nearly all
// of the pass's 3.4 ms a frame of device time.
//
// For ME block (i, j) of picture k of the batch (n current planes of
// ph x pw = nby*bs_y x nbx*bs_x, the pyramid's level 0, against one
// reference), from the pyramid's vector mv and SAD:
//
//   competition (compete = 1)
//     med   = the 3x3 median of each component of the mv field, edge
//             clamped at the grid's border
//     SADs  at med and (zero_cand) at zero, read as me_search reads at
//             radius 0: origin clamp(i*bs_y + margin + hint, 0,
//             ph + 2*margin - round8(bs_y)) - margin, samples edge
//             clamped into the level-0 reference
//     pick  the first minimum of (sad, sad_med - bias, sad_zero - bias),
//             bias = bs_y*bs_x/16, in that order (torch.argmin's pick)
//   subpel (prec > 0), for level 1..prec, from the winner clamped to
//   +-bound:
//     mv   *= 2;  origin = 2*i*bs_y + ((mv << (3 - level)) >> 2) - 1 in
//             half-pel units, clamped as the plain version's patch origin
//             is into the padded plane (sp_margin, round8(2*bs_y + 4))
//     window (2*bs_y + 2) x (2*bs_x + 2) half-pel samples
//             up[clip(y, 0, h2-2), clip(x, 0, w2-2)] of the unpadded
//             half-pel plane (pad_halfpel's clamp)
//     nine candidates (dy, dx) in -1..1, each pixel the renderer's
//             bilinear ((4-ry)(4-rx)p00 + (4-ry)rx p01 + ry(4-rx)p10 +
//             ry rx p11 + 8) >> 4 at the offsets and fractions of
//             SUBPEL_LVL (level 3 by the quarter parity of mv); the first
//             minimum in (dy, dx) order wins and mv += (dy, dx)
//
// Out: dy (n, nby, nbx), dx, sad, int32, back to back in one buffer.
// Everything is integer arithmetic, equal to the plain version bit for
// bit (torch.equal).
//
// What bounds it on this card.  At 1080p (68x120 blocks of 16x16, two
// precision levels) one picture is 2.1 MB of the current plane, 2.1 MB
// of the level-0 reference and 8.3 MB of the half-pel plane, each needed
// once (3.8 us at 3.35 TB/s), against 276 M operations: three per
// absolute difference (subtract, absolute, add) and nine per bilinear
// sample with a nonzero fraction (four multiplies, three adds, the
// rounding add and the shift; none at level 1, eight of the nine
// candidates at level 2), 4.1 us at the 67 TFLOP/s float32 rate the
// repository's bounds use.  So operations bind, narrowly;
// tools/profile_me_final.py times it against that bound.
// What the design does:
//  * One warp per ME block, the whole stage in registers and shared
//    memory: the competition's winner goes straight into the refine, so
//    no field, patch tensor or padded half-pel plane is written to device
//    memory, and the block's vector and SAD leave once.
//  * The half-pel window of each level is staged once into the warp's
//    shared memory (1.2 KB at 16x16); the nine candidates of a pixel are
//    read from the 4x4 samples around it, interpolated vertically first
//    (three rows shared by three candidates each), with offsets and
//    fractions compile-time constants of six template instances (levels
//    1 and 2, level 3's four parity pairs), so nothing is indexed at run
//    time and each of a pixel's 16 samples is read once from shared
//    memory.
//  * Lanes own pixels (consecutive lanes on consecutive columns: a half
//    warp covers a 16-pixel row, in other banks from the other half); the
//    nine sums are reduced with shuffles, and every lane picks the same
//    first minimum, so the warp never diverges on the winner.
//  * The median of nine is a 19-comparator selection network on
//    registers (tests/test_torch_me.py holds it on every 0-1 input, which
//    by the 0-1 principle covers every input).
//
// Build (plain C interface, loaded with ctypes): see csrc/patch_refine.cu.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;            // 4 warps, one ME block each
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxSmem = 48 * 1024;

struct Args {
  const uint8_t* cur;    // (n, ph, pw), ph = nby*bs_y, pw = nbx*bs_x
  const uint8_t* ref;    // (ph, pw), read where compete
  const uint8_t* up;     // (h2, w2), read where prec > 0
  const int32_t* mv;     // (n, nby, nbx, 2)
  const int32_t* sad;    // (n, nby, nbx), read where compete
  int32_t* out;          // (3, n, nby, nbx): dy, dx, sad
  int n, nby, nbx, bs_y, bs_x, h2, w2, prec, compete, zero_cand, bound,
      margin, sp_margin;
};

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// The median of nine: the 19-comparator selection network (Paeth).
__device__ __forceinline__ int median9(int (&p)[9]) {
  sort2(p[1], p[2]); sort2(p[4], p[5]); sort2(p[7], p[8]);
  sort2(p[0], p[1]); sort2(p[3], p[4]); sort2(p[6], p[7]);
  sort2(p[1], p[2]); sort2(p[4], p[5]); sort2(p[7], p[8]);
  sort2(p[0], p[3]); sort2(p[5], p[8]); sort2(p[4], p[7]);
  sort2(p[3], p[6]); sort2(p[1], p[4]); sort2(p[2], p[5]);
  sort2(p[4], p[7]); sort2(p[2], p[4]); sort2(p[4], p[6]);
  sort2(p[2], p[4]);
  return p[4];
}

// SUBPEL_LVL as compile-time functions of a variant v (0: level 1, 1:
// level 2, 2 and 3: level 3 at quarter parity 0 and 2) and a candidate
// offset index d (0, 1, 2 for -1, 0, 1): the half-pel offset of the
// candidate's first tap in the window and its quarter fraction.
__host__ __device__ constexpr int sp_off(int v, int d) {
  return v == 0 ? d : (v == 3 || d != 0) ? 1 : 0;
}
__host__ __device__ constexpr int sp_frac(int v, int d) {
  return v == 0   ? 0
         : v == 1 ? (d == 1 ? 0 : 2)
         : v == 2 ? (d == 0 ? 3 : d == 1 ? 0 : 1)
                  : d + 1;
}

// floor(t / d) as (t * inv) >> 20 with inv = ceil(2^20 / d): exact for
// every d <= 66 and t < 66 * d, a window of the largest block the wrapper
// takes (tests/test_torch_me.py checks every case)
__device__ __forceinline__ unsigned inv_of(int d) {
  return ((1u << 20) + d - 1) / d;
}
__device__ __forceinline__ int div_by(int t, unsigned inv) {
  return static_cast<int>((static_cast<unsigned>(t) * inv) >> 20);
}

// Copy a rows x cols tile into shared memory (row pitch dpitch), byte
// (r, c) read at src(r, c): each lane issues kInFlight loads before their
// stores, so the warp waits on memory once per 256 bytes, not per load.
template <typename Src>
__device__ __forceinline__ void stage(uint8_t* dst, int dpitch, int rows,
                                      int cols, int lane, const Src& src) {
  constexpr int kInFlight = 8;
  const int n = rows * cols;
  const unsigned inv = inv_of(cols);
  for (int t0 = 0; t0 < n; t0 += 32 * kInFlight) {
    uint8_t v[kInFlight];
    int at[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int t = t0 + 32 * q + lane;
      const int r = div_by(t, inv);
      const int c = t - r * cols;
      at[q] = t < n ? r * dpitch + c : -1;
      v[q] = t < n ? __ldg(src(r, c)) : 0;
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q)
      if (at[q] >= 0) dst[at[q]] = v[q];
  }
}

// The nine candidates' partial SADs over this lane's pixels of the
// block: cur the staged block (row pitch bs_x), win the staged window
// (row pitch wpitch).
template <int VY, int VX>
__device__ __forceinline__ void score9(const uint8_t* cur,
                                       const uint8_t* win, int wpitch,
                                       int bs_y, int bs_x, int lane,
                                       uint32_t (&acc)[9]) {
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = 0;
  const int npx = bs_y * bs_x;
  const unsigned inv = inv_of(bs_x);
  for (int t = lane; t < npx; t += 32) {
    const int r = div_by(t, inv);
    const int c = t - r * bs_x;
    const int cv = cur[t];
    const uint8_t* w0 = win + 2 * r * wpitch + 2 * c;
    int s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) s[u][v] = w0[u * wpitch + v];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int oy = sp_off(VY, a);
      const int ry = sp_frac(VY, a);
      int vert[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        vert[v] = (4 - ry) * s[oy][v] + ry * s[oy + 1][v];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int ox = sp_off(VX, b);
        const int rx = sp_frac(VX, b);
        const int pred = ((4 - rx) * vert[ox] + rx * vert[ox + 1] + 8) >> 4;
        acc[3 * a + b] += static_cast<uint32_t>(abs(cv - pred));
      }
    }
  }
}

// Shared-memory bytes of one warp: the current block, then (prec > 0) the
// half-pel window of (2*bs_y + 2) rows of (2*bs_x + 2) bytes.
__host__ __device__ inline int slice_bytes(int bs_y, int bs_x, int prec) {
  const int block = (bs_y * bs_x + 15) & ~15;
  return prec > 0 ? block + (2 * bs_y + 2) * ((2 * bs_x + 2 + 3) & ~3)
                  : block;
}

__global__ void __launch_bounds__(kThreads) me_final_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nb = p.nby * p.nbx;
  const int b = blockIdx.x * kWarps + warp;
  // the whole warp leaves together; no block-wide barrier is used below
  if (b >= nb) return;
  const int k = blockIdx.y;
  const int i = b / p.nbx;
  const int j = b - i * p.nbx;
  const int ph = p.nby * p.bs_y;
  const int pw = p.nbx * p.bs_x;
  const int npx = p.bs_y * p.bs_x;
  const size_t m = static_cast<size_t>(k) * nb + b;
  // the warp's slice: the current block, then the half-pel window
  uint8_t* cur = smem + warp * slice_bytes(p.bs_y, p.bs_x, p.prec);
  {
    const uint8_t* src = p.cur + static_cast<size_t>(k) * ph * pw +
                         static_cast<size_t>(i * p.bs_y) * pw + j * p.bs_x;
    stage(cur, p.bs_x, p.bs_y, p.bs_x, lane,
          [&](int r, int c) { return src + r * pw + c; });
  }
  __syncwarp();
  int my = p.mv[2 * m];
  int mx = p.mv[2 * m + 1];
  uint32_t sad = 0;

  if (p.compete) {
    const int32_t* f = p.mv + static_cast<size_t>(k) * nb * 2;
    int vy[9], vx[9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int ii = clampi(i + a - 1, 0, p.nby - 1);
        const int jj = clampi(j + c - 1, 0, p.nbx - 1);
        vy[3 * a + c] = __ldg(f + 2 * (ii * p.nbx + jj));
        vx[3 * a + c] = __ldg(f + 2 * (ii * p.nbx + jj) + 1);
      }
    }
    const int med_y = median9(vy);
    const int med_x = median9(vx);
    // me_search's radius-0 windows: the median's hint (scale 1) clamped
    // to the bound, the zero vector's hint 0
    const int ylim = ph + 2 * p.margin - round8(p.bs_y);
    const int xlim = pw + 2 * p.margin - round8(p.bs_x);
    const int my0 = clampi(i * p.bs_y + p.margin +
                           clampi(med_y, -p.bound, p.bound), 0, ylim) -
                    p.margin;
    const int mx0 = clampi(j * p.bs_x + p.margin +
                           clampi(med_x, -p.bound, p.bound), 0, xlim) -
                    p.margin;
    const int zy0 = clampi(i * p.bs_y + p.margin, 0, ylim) - p.margin;
    const int zx0 = clampi(j * p.bs_x + p.margin, 0, xlim) - p.margin;
    uint32_t s_med = 0, s_zero = 0;
    const unsigned inv = inv_of(p.bs_x);
#pragma unroll 4
    for (int t = lane; t < npx; t += 32) {
      const int r = div_by(t, inv);
      const int c = t - r * p.bs_x;
      const int cv = cur[t];
      const int rm = __ldg(p.ref +
                           static_cast<size_t>(clampi(my0 + r, 0, ph - 1)) *
                               pw +
                           clampi(mx0 + c, 0, pw - 1));
      s_med += static_cast<uint32_t>(abs(cv - rm));
      if (p.zero_cand) {
        const int rz = __ldg(
            p.ref + static_cast<size_t>(clampi(zy0 + r, 0, ph - 1)) * pw +
            clampi(zx0 + c, 0, pw - 1));
        s_zero += static_cast<uint32_t>(abs(cv - rz));
      }
    }
    s_med = warp_sum(s_med);
    s_zero = warp_sum(s_zero);
    const int bias = npx / 16;
    sad = static_cast<uint32_t>(p.sad[m]);
    int key = static_cast<int>(sad);
    if (static_cast<int>(s_med) - bias < key) {
      key = static_cast<int>(s_med) - bias;
      my = med_y;
      mx = med_x;
      sad = s_med;
    }
    if (p.zero_cand && static_cast<int>(s_zero) - bias < key) {
      my = 0;
      mx = 0;
      sad = s_zero;
    }
  }

  if (p.prec > 0) {
    const int wh = 2 * p.bs_y + 2;
    const int ww = 2 * p.bs_x + 2;
    const int wpitch = (ww + 3) & ~3;
    uint8_t* win = cur + ((npx + 15) & ~15);
    // the plain version's patch origins are clamped into the half-pel
    // plane padded by sp_margin, patches round8(2*bs + 4) wide
    const int ylim = p.h2 + 2 * p.sp_margin - round8(2 * p.bs_y + 4);
    const int xlim = p.w2 + 2 * p.sp_margin - round8(2 * p.bs_x + 4);
    my = clampi(my, -p.bound, p.bound);
    mx = clampi(mx, -p.bound, p.bound);
    for (int level = 1; level <= p.prec; ++level) {
      my *= 2;
      mx *= 2;
      const int sh = 3 - level;
      const int y0 = clampi(2 * i * p.bs_y + ((my * (1 << sh)) >> 2) - 1 +
                                p.sp_margin, 0, ylim) - p.sp_margin;
      const int x0 = clampi(2 * j * p.bs_x + ((mx * (1 << sh)) >> 2) - 1 +
                                p.sp_margin, 0, xlim) - p.sp_margin;
      __syncwarp();                 // the last level's reads are done
      stage(win, wpitch, wh, ww, lane, [&](int r, int c) {
        return p.up + static_cast<size_t>(clampi(y0 + r, 0, p.h2 - 2)) *
                          p.w2 + clampi(x0 + c, 0, p.w2 - 2);
      });
      __syncwarp();
      uint32_t acc[9];
      const bool py2 = (my & 3) == 2;
      const bool px2 = (mx & 3) == 2;
      if (level == 1) {
        score9<0, 0>(cur, win, wpitch, p.bs_y, p.bs_x, lane, acc);
      } else if (level == 2) {
        score9<1, 1>(cur, win, wpitch, p.bs_y, p.bs_x, lane, acc);
      } else if (!py2 && !px2) {
        score9<2, 2>(cur, win, wpitch, p.bs_y, p.bs_x, lane, acc);
      } else if (!py2) {
        score9<2, 3>(cur, win, wpitch, p.bs_y, p.bs_x, lane, acc);
      } else if (!px2) {
        score9<3, 2>(cur, win, wpitch, p.bs_y, p.bs_x, lane, acc);
      } else {
        score9<3, 3>(cur, win, wpitch, p.bs_y, p.bs_x, lane, acc);
      }
      uint32_t best = warp_sum(acc[0]);
      int best_q = 0;
#pragma unroll
      for (int q = 1; q < 9; ++q) {
        const uint32_t s = warp_sum(acc[q]);
        if (s < best) {
          best = s;
          best_q = q;
        }
      }
      my += best_q / 3 - 1;
      mx += best_q % 3 - 1;
      sad = best;
    }
  }

  if (lane == 0) {
    const size_t plane = static_cast<size_t>(p.n) * nb;
    p.out[m] = my;
    p.out[plane + m] = mx;
    p.out[2 * plane + m] = static_cast<int32_t>(sad);
  }
}

}  // namespace

// The final stage of one ME pass over a batch of n pictures on `stream`
// (see the head note).  Returns cudaGetLastError() (0 = launched), 0
// without a launch for an empty grid (n, nby or nbx <= 0), -1 for a
// precision outside 0..3 or for precision 0 without the competition, -2
// when a block's windows need more than 48 KB of shared memory, -3 for a
// batch of more than 65535 pictures (the grid's y limit).
extern "C" int me_final_launch(int n, const void* cur, const void* ref,
                               const void* up, const void* mv,
                               const void* sad, void* out, int nby, int nbx,
                               int bs_y, int bs_x, int h2, int w2, int prec,
                               int compete, int zero_cand, int bound,
                               int margin, int sp_margin, void* stream) {
  if (nby <= 0 || nbx <= 0 || n <= 0) return 0;
  if (n > 65535) return -3;
  if (prec < 0 || prec > 3 || (prec == 0 && !compete)) return -1;
  Args p{static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
         static_cast<const uint8_t*>(up), static_cast<const int32_t*>(mv),
         static_cast<const int32_t*>(sad), static_cast<int32_t*>(out),
         n, nby, nbx, bs_y, bs_x, h2, w2, prec, compete, zero_cand, bound,
         margin, sp_margin};
  const int smem = kWarps * slice_bytes(bs_y, bs_x, prec);
  if (smem > kMaxSmem) return -2;
  const int nb = nby * nbx;
  me_final_kernel<<<dim3((nb + kWarps - 1) / kWarps, n), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
