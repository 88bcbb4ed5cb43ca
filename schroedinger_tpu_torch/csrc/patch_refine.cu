// ME full-pel SAD search for Hopper (sm_90a): every full-pel search of the
// ME pyramid in one kernel.
//
// Replaces the Pallas TPU kernel schroedinger_tpu/ops/pallas_me.py:71
// make_patch_refine, and also serves what the JAX ME computes around it
// without Pallas: the coarse scan (encoder/me.py _dense_scan) and the
// final competition's median and zero SADs.  For every ME block (i, j) of
// the nby x nbx grid on the u8 level planes cur and ref (h x w, unpadded):
//
//   hint   = clamp(scale * F[i*hy/nby, j*hx/nbx], -bound, bound)
//            (0 when scale == 0 or there is no field F)
//   origin = clamp(i*bs_y + margin - rad + hint_y, 0,
//                  h + 2*margin - round8(bs_y + 2*rad)), the same in x,
//            in the virtual plane padded by `margin` on every side, as
//            jax.lax.dynamic_slice clamps its start
//   sample = ref[clamp(origin_y + r - margin, 0, h-1),
//                clamp(origin_x + c - margin, 0, w-1)], which reads the
//            unpadded plane exactly as the edge-padded copy would be read
//
// and the SAD of all (2rad+1)^2 candidates; the first minimum in (dy, dx)
// order wins (the 64-bit key (sad << 32) | candidate, smallest first).
// Out: mv (nby, nbx, 2) int32 = hint + (a - rad, b - rad), then sad
// (nby, nbx) int32, in one buffer; mv is the next level's F as it is.
//
// A batch of n current planes against one shared reference (the B
// pictures of a subgroup share both references) is one launch: the
// picture is blockIdx.y, cur and F hold n planes and fields back to back,
// and the buffer holds the n mv fields, then the n sad fields.  n = 1 is
// the single-picture search, with the same grid and the same code.
//
// What bounds it on this card.  At the finest 1080p level (68x120 blocks
// of 16x16, rad 2) one call is 52 M absolute differences over 4.2 MB of
// u8 planes: operations bind at levels 0 and 1 (0.0023 ms at the float32
// rate the bound uses), bytes or the launch itself everywhere else.  In
// practice the first bound met is the number of distinct cache lines a
// warp's load touches: a first version in which each lane read its own
// window rows straight from device memory spent 0.0123 of level 0's
// 0.0187 ms on those reads (the probe's full - nostage).  What the
// design does:
//  * u8 end to end.  The current block is read from the u8 level plane
//    into registers as packed 32-bit words (16-, 8- or 4-byte loads, one
//    per lane); the reference windows are read from the unpadded u8 plane:
//    no int32 copy of the blocks and no padded copy of the reference.
//  * Windows staged once per block.  The rows kernel copies each ME
//    block's window into its warp's shared memory as aligned 16-byte
//    chunks (4-byte where the plane's width is not a multiple of 16): a
//    window row costs one or two cache lines, not one per lane.  Only a
//    window that touches the plane's border is gathered byte by byte with
//    every sample clamped.  Lanes then read their words from shared
//    memory at the window's byte offset and realign them with
//    __funnelshift_r.  Row pitches are odd word counts, so the lanes'
//    rows fall on other banks (at most 2-way conflicts).
//  * Packed-byte SADs.  __vsadu4 sums |a - b| over 4 pixels at a time
//    (it compiles to VABSDIFF4.U8.ACC, one instruction: cuobjdump -sass);
//    candidates whose dx is not a multiple of 4 are aligned with
//    __funnelshift_r by a compile-time amount.
//  * Every lane busy ("rows" kernel, radius <= 2).  A lane owns one row
//    of its ME block: at 16x16 a warp serves 2 blocks, at 8x8 4, at 4x4
//    8.  Each lane sums its row for every candidate (25 at radius 2) in
//    registers, and a butterfly reduce-scatter over the block's lanes
//    (16 + 8 + 4 + 2 shuffles at 16x16) leaves each lane the sums of its
//    own candidates, so the first minimum costs a few more shuffle steps.
//    At radius 8 (289 candidates on 4x4 blocks) lanes own candidates
//    instead ("cands" kernel): one warp per ME block, window and block
//    staged in shared memory.
//  * Latency hidden by occupancy: loops are unrolled at compile time, a
//    lane issues all its loads before it sums, and many small warps are
//    resident per SM.  cp.async with double buffering across a strip of
//    blocks is not done: staging is now a minor part of the time (the
//    probe's full - nostage at level 0, PERF.md section 6).
//  * Specialised, not fallen back: template instances for the main path's
//    (bs_y, bs_x, rad) = (16,16,2), (16,16,0), (8,8,2), (4,4,2) (rows) and
//    (4,4,8) (cands); a generic cands instance, still this kernel, takes
//    any other shape with its sizes at run time.
//
// Cost probe (replaces the TPU probe tools/profile_pk_parts.py:113, which
// timed that kernel's DMA, lane roll and SAD loop apart): the kernels are
// templates on kProbe, and me_search_launch's `variant` picks one of four
// variants so that their times split this kernel's time into its parts.
// Only kFull gives right answers:
//   kFull       the kernel as the encoder runs it
//   kNoStage    no window staging: the search runs over whatever shared
//               memory holds (full - nostage = the window reads)
//   kNoSad      the window is read, one candidate is searched (full -
//               nosad = the other candidates' SADs and their reduction)
//   kOneWindow  every ME block reads block 0's window, so the window
//               reads hit cache (full - onewindow = their misses)
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -Xptxas -v
// ptxas -v (CUDA 12.8, sm_90a), the search (variant 0) instances:
//   rows  (16,16,2)  40 registers, 8320 bytes smem, 0 spill, 0 stack
//   rows  (16,16,0)  32 registers, 4608 bytes smem, 0 spill, 0 stack
//   rows  (8,8,2)    40 registers, 6912 bytes smem, 0 spill, 0 stack
//   rows  (4,4,2)    32 registers, 9728 bytes smem, 0 spill, 0 stack
//   cands (4,4,8)    32 registers, dynamic smem,    0 spill, 0 stack
//   cands generic    40 registers, dynamic smem,    0 spill, 0 stack
// (the probe's variants: 24-48 registers, no spill).  chip_smoke.py
// phase 1 prints these lines on every build.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;            // 4 warps per thread block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxSmem = 48 * 1024;      // the cands kernel's slices

enum Probe { kFull = 0, kNoStage = 1, kNoSad = 2, kOneWindow = 3 };

struct Args {
  const uint8_t* cur;                    // (n, h, w)
  const uint8_t* ref;                    // (h, w), shared
  const int32_t* field;                  // (n, hy, hx, 2) or null
  int32_t* mv;                           // (n, nb, 2)
  int32_t* sad;                          // (n, nb)
  int h, w, hy, hx, scale, bs_y, bs_x, rad, bound, margin, nby, nbx;
};

// The arguments of picture blockIdx.y of the batch.
__device__ __forceinline__ Args picture_of(const Args& a) {
  Args p = a;
  const size_t n = blockIdx.y;
  const size_t nb = static_cast<size_t>(a.nby) * a.nbx;
  p.cur += n * a.h * a.w;
  if (a.field != nullptr) p.field += n * 2 * a.hy * a.hx;
  p.mv += n * 2 * nb;
  p.sad += n * nb;
  return p;
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

struct Window {
  int hint_y, hint_x;  // the block's clamped hint
  int y0, x0;          // window origin in the unpadded plane
};

// The hint and window of ME block (i, j) for a (by + 2rad) x (bx + 2rad)
// search window.
__device__ __forceinline__ Window window_of(const Args& p, int i, int j,
                                            int by, int bx, int rad) {
  int hy = 0, hx = 0;
  if (p.field != nullptr && p.scale != 0) {
    const int32_t* f =
        p.field + 2 * ((i * p.hy / p.nby) * p.hx + j * p.hx / p.nbx);
    // wrapping multiply, as int32 tensors multiply
    hy = static_cast<int>(static_cast<unsigned>(p.scale) *
                          static_cast<unsigned>(f[0]));
    hx = static_cast<int>(static_cast<unsigned>(p.scale) *
                          static_cast<unsigned>(f[1]));
    hy = clampi(hy, -p.bound, p.bound);
    hx = clampi(hx, -p.bound, p.bound);
  }
  const int oy = clampi(i * by + p.margin - rad + hy, 0,
                        p.h + 2 * p.margin - round8(by + 2 * rad));
  const int ox = clampi(j * bx + p.margin - rad + hx, 0,
                        p.w + 2 * p.margin - round8(bx + 2 * rad));
  return {hy, hx, oy - p.margin, ox - p.margin};
}

__device__ __forceinline__ unsigned long long key_of(uint32_t sad,
                                                     int cand) {
  return (static_cast<unsigned long long>(sad) << 32) |
         static_cast<uint32_t>(cand);
}

__device__ __forceinline__ unsigned long long min_over(
    unsigned long long v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kAll, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ void write_out(const Args& p, int b,
                                          const Window& wv,
                                          unsigned long long best, int K,
                                          int rad) {
  const int cand = static_cast<int>(best & 0xffffffffull);
  p.mv[2 * b] = wv.hint_y + cand / K - rad;
  p.mv[2 * b + 1] = wv.hint_x + cand % K - rad;
  p.sad[b] = static_cast<int32_t>(best >> 32);
}

// Butterfly reduce-scatter over the lanes of a group (xor offsets O,
// O/2, .. 1): N partial sums per lane become N/2 at each step, the lane
// with the offset's bit set keeping the upper half; once one value is
// left the remaining steps only add.  `base` collects the index of the
// first value a lane keeps.
template <int N, int O, int NV>
__device__ __forceinline__ void reduce_scatter(uint32_t (&v)[NV], int lane,
                                               int& base) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const uint32_t send = up ? v[k] : v[k + N / 2];
        const uint32_t keep = up ? v[k + N / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(kAll, send, O);
      }
      if (up) base += N / 2;
      reduce_scatter<N / 2, O / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(kAll, v[0], O);
      reduce_scatter<1, O / 2>(v, lane, base);
    }
  }
}

// --- rows kernel: lanes own slices of the current block ----------------

template <int BY, int BX, int R>
struct RowsShape {
  static constexpr int kSlice = BX < 16 ? BX : 16;  // px of a row a lane owns
  static constexpr int kWords = kSlice / 4;
  static constexpr int kLanesPerRow = BX / kSlice;
  static constexpr int kGroup = BY * kLanesPerRow;  // lanes per ME block
  static constexpr int kBlocks = 32 / kGroup;       // ME blocks per warp
  static_assert(BX % 4 == 0 && BX % kSlice == 0, "block width");
  static_assert(kGroup <= 32 && 32 % kGroup == 0, "lanes per block");
  // the staged window: its rows, and the 16-byte (or, where the plane's
  // width is not a multiple of 16, 4-byte) chunks that cover its columns
  // at any alignment
  static constexpr int kRows = BY + 2 * R;
  static constexpr int kCols = BX + 2 * R;
  static constexpr int kChunks16 = (kCols + 15 + 15) / 16;
  static constexpr int kChunks4 = (kCols + 3 + 3) / 4;
  // shared-memory words of a window row (odd: rows fall on other banks)
  // and of a block's window (padded at 4 px, where 8 windows share a warp)
  static constexpr int kPitch = 4 * kChunks16 + 1;
  static constexpr int kStride = kRows * kPitch + (BX == 4 ? 4 : 0);
};

// Stage the windows of a warp's ME blocks into its shared memory: a
// window inside the plane as aligned 16-byte (or 4-byte) chunks from the
// u8 plane, its first column `off` bytes into the row; a window that
// touches the border byte by byte with every sample clamped (off = 0).
// Every lane takes part (the shuffles fetch each block's window from the
// first lane of its group); returns this lane's block's `off`.
template <int BY, int BX, int R>
__device__ __forceinline__ int stage_windows(const Args& p, const Window& wv,
                                             uint32_t* win, int lane) {
  using S = RowsShape<BY, BX, R>;
  constexpr int G = S::kGroup;
  const bool inside = wv.y0 >= 0 && wv.y0 + S::kRows <= p.h &&
                      wv.x0 >= 0 && wv.x0 + S::kCols <= p.w;
  const bool wide = (p.w & 15) == 0;
  const int cb = wide ? 16 : 4;                 // chunk bytes
  const int nch = wide ? S::kChunks16 : S::kChunks4;
  const int items = S::kBlocks * S::kRows * nch;
  for (int t0 = 0; t0 < items; t0 += 32) {      // uniform: shuffles inside
    const int t = t0 + lane;
    const int q = min(t / (S::kRows * nch), S::kBlocks - 1);
    const int y0 = __shfl_sync(kAll, wv.y0, q * G);
    const int x0 = __shfl_sync(kAll, wv.x0, q * G);
    const bool in_q = __shfl_sync(kAll, inside ? 1 : 0, q * G) != 0;
    if (t >= items) continue;
    const int rem = t - q * S::kRows * nch;
    const int r = rem / nch;
    const int ch = rem - r * nch;
    uint32_t* dst = win + q * S::kStride + r * S::kPitch + ch * (cb / 4);
    if (in_q) {
      const int start = x0 & ~(cb - 1);
      if (ch * cb >= x0 - start + S::kCols) continue;   // past the window
      const uint8_t* src =
          p.ref + static_cast<size_t>(y0 + r) * p.w + start + ch * cb;
      if (wide) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      } else {
        dst[0] = __ldg(reinterpret_cast<const uint32_t*>(src));
      }
    } else {
      const uint8_t* row =
          p.ref + static_cast<size_t>(clampi(y0 + r, 0, p.h - 1)) * p.w;
      for (int k = 0; k < cb / 4; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v |= static_cast<uint32_t>(__ldg(
                   row + clampi(x0 + ch * cb + 4 * k + b, 0, p.w - 1)))
               << (8 * b);
        dst[k] = v;
      }
    }
  }
  return inside ? wv.x0 & (cb - 1) : 0;
}

template <int BY, int BX, int R, int kProbe>
__global__ void __launch_bounds__(kThreads)
    me_rows_kernel(const Args a) {
  const Args p = picture_of(a);
  using S = RowsShape<BY, BX, R>;
  constexpr int G = S::kGroup;
  constexpr int WPL = S::kWords;
  constexpr int K = 2 * R + 1;
  constexpr int NC = K * K;
  constexpr int NV = pow2_at_least(NC);
  static_assert(NV <= 32, "rows kernel: at most 32 candidates");
  constexpr int L = 4 * WPL + 2 * R;        // window bytes a lane reads a row
  constexpr int NW = (L + 3) / 4;           // realigned words (+1 spare)
  constexpr int NG = (L + 2) / 4 + 1;       // aligned words at any shift
  __shared__ uint32_t smem[kWarps][S::kBlocks * S::kStride];

  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const int row = gl / S::kLanesPerRow;
  const int seg = gl % S::kLanesPerRow;
  const int nb = p.nby * p.nbx;
  const int b = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * S::kBlocks +
                lane / G;
  const bool active = b < nb;
  // a lane past the last block searches the last one and writes nothing:
  // every lane takes part in the shuffles
  const int bb = active ? b : nb - 1;
  const int i = bb / p.nbx;
  const int j = bb - i * p.nbx;
  const Window wv = kProbe == kOneWindow ? window_of(p, 0, 0, BY, BX, R)
                                         : window_of(p, i, j, BY, BX, R);

  uint32_t cw[WPL];
  {
    const uint8_t* c = p.cur + static_cast<size_t>(i * BY + row) * p.w +
                       j * BX + seg * S::kSlice;
    if constexpr (WPL == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(c));
      cw[0] = v.x;
      cw[1] = v.y;
      cw[2] = v.z;
      cw[3] = v.w;
    } else if constexpr (WPL == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(c));
      cw[0] = v.x;
      cw[1] = v.y;
    } else {
      cw[0] = __ldg(reinterpret_cast<const uint32_t*>(c));
    }
  }

  uint32_t* win = smem[threadIdx.x >> 5];
  int off = 0;
  if (kProbe != kNoStage) off = stage_windows<BY, BX, R>(p, wv, win, lane);
  __syncwarp();
  // this lane's first window byte: `off` into its block's staged rows,
  // then its slice
  const int sh = off & 3;
  const uint32_t* mine = win + (lane / G) * S::kStride + row * S::kPitch +
                         (off >> 2) + seg * WPL;

  uint32_t acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0;
  uint32_t sink = 0;

#pragma unroll
  for (int a = 0; a < K; ++a) {
    uint32_t gw[NG];
#pragma unroll
    for (int k = 0; k < NG; ++k) gw[k] = mine[a * S::kPitch + k];
    uint32_t W[NW + 1];
    W[NW] = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k)
      W[k] = __funnelshift_r(gw[k], gw[k + 1], 8 * sh);
#pragma unroll
    for (int bc = 0; bc < K; ++bc) {
      if (kProbe == kNoSad && (a != 0 || bc != 0)) continue;
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const uint32_t lo = W[k + bc / 4];
        const uint32_t v =
            bc % 4 ? __funnelshift_r(lo, W[k + bc / 4 + 1], 8 * (bc % 4))
                   : lo;
        acc[a * K + bc] = __vsadu4(cw[k], v) + acc[a * K + bc];
      }
    }
    if (kProbe == kNoSad) {
#pragma unroll
      for (int k = 0; k < NW; ++k) sink ^= W[k];
    }
  }
  if (kProbe == kNoSad) acc[0] += sink & 1u;

  int base = 0;
  reduce_scatter<NV, G / 2>(acc, lane, base);
  constexpr int NF = NV / G > 0 ? NV / G : 1;
  constexpr int ncand = kProbe == kNoSad ? 1 : NC;
  unsigned long long best = ~0ull;
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    if (base + k < ncand) {
      const unsigned long long key = key_of(acc[k], base + k);
      best = key < best ? key : best;
    }
  }
  best = min_over(best, G);
  if (active && gl == 0) write_out(p, b, wv, best, K, R);
}

// --- cands kernel: lanes own candidates ---------------------------------

__host__ __device__ inline int cands_slice_bytes(int by, int bx, int rad) {
  const int cpitch = (bx + 3) & ~3;
  const int wpitch = ((bx + 2 * rad + 3) & ~3) + 4;   // one spare word
  return (by * cpitch + (by + 2 * rad) * wpitch + 15) & ~15;
}

// BY_, BX_, R_ = 0: the generic instance, sizes from the arguments.
template <int BY_, int BX_, int R_, int kProbe>
__global__ void __launch_bounds__(kThreads)
    me_cands_kernel(const Args a) {
  const Args p = picture_of(a);
  extern __shared__ __align__(16) unsigned char smem[];
  const int by = BY_ ? BY_ : p.bs_y;
  const int bx = BX_ ? BX_ : p.bs_x;
  const int rad = BY_ ? R_ : p.rad;
  const int K = 2 * rad + 1;
  const int wh = by + 2 * rad;
  const int ww = bx + 2 * rad;
  const int cpitch = (bx + 3) & ~3;
  const int wpitch = ((ww + 3) & ~3) + 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  // the whole warp leaves together; no block-wide barrier is used below
  if (b >= p.nby * p.nbx) return;
  uint8_t* cur_s = smem + warp * cands_slice_bytes(by, bx, rad);
  uint8_t* win_s = cur_s + by * cpitch;
  const int i = b / p.nbx;
  const int j = b - i * p.nbx;
  const Window wv = kProbe == kOneWindow ? window_of(p, 0, 0, by, bx, rad)
                                         : window_of(p, i, j, by, bx, rad);

  for (int t = lane; t < by * bx; t += 32) {
    const int r = t / bx;
    const int c = t - r * bx;
    cur_s[r * cpitch + c] =
        p.cur[static_cast<size_t>(i * by + r) * p.w + j * bx + c];
  }
  if (kProbe != kNoStage) {
    for (int t = lane; t < wh * ww; t += 32) {
      const int r = t / ww;
      const int c = t - r * ww;
      win_s[r * wpitch + c] =
          p.ref[static_cast<size_t>(clampi(wv.y0 + r, 0, p.h - 1)) * p.w +
                clampi(wv.x0 + c, 0, p.w - 1)];
    }
  }
  __syncwarp();

  unsigned long long best = ~0ull;
  const int ncand = kProbe == kNoSad ? 1 : K * K;
  for (int cand = lane; cand < ncand; cand += 32) {
    const int a = cand / K;
    const int bc = cand - a * K;
    uint32_t s = 0;
    if (bx % 4 == 0) {
      const int q = bc >> 2;
      const int shift = 8 * (bc & 3);
      for (int r = 0; r < by; ++r) {
        const uint32_t* cr =
            reinterpret_cast<const uint32_t*>(cur_s + r * cpitch);
        const uint32_t* wr =
            reinterpret_cast<const uint32_t*>(win_s + (a + r) * wpitch) + q;
#pragma unroll 4
        for (int c4 = 0; c4 < bx / 4; ++c4)
          s = __vsadu4(cr[c4], __funnelshift_r(wr[c4], wr[c4 + 1], shift)) +
              s;
      }
    } else {
      for (int r = 0; r < by; ++r)
        for (int c = 0; c < bx; ++c)
          s += abs(static_cast<int>(cur_s[r * cpitch + c]) -
                   static_cast<int>(win_s[(a + r) * wpitch + bc + c]));
    }
    const unsigned long long key = key_of(s, cand);
    best = key < best ? key : best;
  }
  best = min_over(best, 32);
  if (lane == 0) write_out(p, b, wv, best, K, rad);
}

// --- launch -------------------------------------------------------------

template <int BY, int BX, int R, int kProbe>
int launch_rows(const Args& p, int n, cudaStream_t stream) {
  constexpr int per_warp = RowsShape<BY, BX, R>::kBlocks;
  const int warps = (p.nby * p.nbx + per_warp - 1) / per_warp;
  me_rows_kernel<BY, BX, R, kProbe>
      <<<dim3((warps + kWarps - 1) / kWarps, n), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BY, int BX, int R, int kProbe>
int launch_cands(const Args& p, int n, cudaStream_t stream) {
  const int smem = kWarps * cands_slice_bytes(p.bs_y, p.bs_x, p.rad);
  if (smem > kMaxSmem) return -2;
  me_cands_kernel<BY, BX, R, kProbe>
      <<<dim3((p.nby * p.nbx + kWarps - 1) / kWarps, n), kThreads, smem,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kProbe>
int launch(const Args& p, int n, cudaStream_t stream) {
  const int by = p.bs_y, bx = p.bs_x, rad = p.rad;
  if (by == 16 && bx == 16 && rad == 2)
    return launch_rows<16, 16, 2, kProbe>(p, n, stream);
  if (by == 16 && bx == 16 && rad == 0)
    return launch_rows<16, 16, 0, kProbe>(p, n, stream);
  if (by == 8 && bx == 8 && rad == 2)
    return launch_rows<8, 8, 2, kProbe>(p, n, stream);
  if (by == 4 && bx == 4 && rad == 2)
    return launch_rows<4, 4, 2, kProbe>(p, n, stream);
  if (by == 4 && bx == 4 && rad == 8)
    return launch_cands<4, 4, 8, kProbe>(p, n, stream);
  return launch_cands<0, 0, 0, kProbe>(p, n, stream);
}

}  // namespace

// One search of a batch of n pictures on `stream` (see the head note);
// variant 0 is the search, 1..3 the cost probe's variants (Probe above).
// Returns cudaGetLastError() (0 = launched), -1 for an unknown variant,
// -2 when a generic shape needs more than 48 KB of shared memory, -3 for
// a batch of more than 65535 pictures (the grid's y limit).
extern "C" int me_search_launch(int variant, int n, const void* cur,
                                const void* ref, const void* field,
                                void* out, int h, int w, int hy, int hx,
                                int scale, int bs_y, int bs_x, int rad,
                                int bound, int margin, void* stream) {
  const int nby = h / bs_y, nbx = w / bs_x;
  int32_t* mv = static_cast<int32_t*>(out);
  Args p{static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
         static_cast<const int32_t*>(field), mv,
         mv + 2 * static_cast<size_t>(n) * nby * nbx,
         h, w, hy, hx, scale, bs_y, bs_x, rad, bound, margin, nby, nbx};
  if (nby <= 0 || nbx <= 0 || n <= 0) return 0;
  if (n > 65535) return -3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull:
      return launch<kFull>(p, n, st);
    case kNoStage:
      return launch<kNoStage>(p, n, st);
    case kNoSad:
      return launch<kNoSad>(p, n, st);
    case kOneWindow:
      return launch<kOneWindow>(p, n, st);
    default:
      return -1;
  }
}
