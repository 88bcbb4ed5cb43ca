// ME patch-refine search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel schroedinger_tpu/ops/pallas_me.py:71
// make_patch_refine.  For every ME block it runs an exhaustive
// (2*rad+1)^2 full-pel SAD search in the margin-padded reference P around
// that block's hint MV, and returns the winning MV and its SAD.  Ties go to
// the first candidate in (dy, dx) lexicographic order, exactly as
// encoder/me.py _patch_refine (a stacked argmin) resolves them.
//
// What bounds it on this card: latency and launch, not arithmetic or
// bytes.  At the finest 1080p level (68x120 blocks of 16x16, rad 2) one
// call is about 52 M absolute differences over a ~3 MB u8 plane (counts
// from the shapes), far below what the card's integer units and memory
// move in the time of a launch, so the kernel is simple on purpose: one
// warp per ME block, four ME blocks per thread block.  The
// warp stages the block's (bs_y+2rad)x(bs_x+2rad) reference window (u8)
// and the current block (int32) in shared memory, its lanes share out the
// candidates and sum SADs in int32, and a warp shuffle takes the minimum
// of the 64-bit key (sad << 32 | candidate index), whose smallest value is
// the lexicographically first minimum.  The TPU kernel's tricks (16
// pre-shifted copies of P, the 128-lane window bound, floor-and-fold
// remainders) answered Mosaic's alignment rules and are not carried over.
// Fusing the pyramid levels or batching pictures into one launch is later
// work.
//
// The window origin is clamped into P as jax.lax.dynamic_slice clamps its
// start (origin i*bs_y + margin - rad + mv_y, clamped to
// [0, Ph - round8(bs_y + 2*rad)], the same in x), so kernel and plain
// version agree even for hints outside the |mv| <= margin - rad contract.
//
// Cost probe (replaces the TPU probe tools/profile_pk_parts.py:113, which
// timed that kernel's DMA, lane roll and SAD loop apart): the kernel is a
// template on kProbe, and patch_refine_probe_launch runs one of four
// variants so that their times split this kernel's time into ITS parts.
// Only kFull gives right answers:
//   kFull       the kernel as the encoder runs it
//   kNoStage    no global-to-shared load of the reference window: the SAD
//               loop runs over whatever shared memory holds (full - nostage
//               = window staging)
//   kNoSad      stage, then one candidate only, then reduce (full - nosad =
//               24 of the 25 SAD loops)
//   kOneWindow  every warp stages the window of block 0, so the reference
//               reads hit cache (full - onewindow = device-memory misses of
//               the window reads)
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

enum Probe { kFull = 0, kNoStage = 1, kNoSad = 2, kOneWindow = 3 };

__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }

__host__ __device__ inline int warp_slice_bytes(int bs_y, int bs_x, int rad) {
  const int win = (bs_y + 2 * rad) * (bs_x + 2 * rad);
  return bs_y * bs_x * 4 + ((win + 15) & ~15);
}

template <int kProbe>
__global__ void patch_refine_kernel(
    const int32_t* __restrict__ cur, const uint8_t* __restrict__ P,
    const int32_t* __restrict__ mvy, const int32_t* __restrict__ mvx,
    int32_t* __restrict__ dy, int32_t* __restrict__ dx,
    int32_t* __restrict__ sad, int nby, int nbx, int bs_y, int bs_x,
    int rad, int margin, int Ph, int Pw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  // The whole warp leaves together; no block-wide barrier is used below.
  if (b >= nby * nbx) return;

  const int K = 2 * rad + 1;
  const int wh = bs_y + 2 * rad;
  const int ww = bs_x + 2 * rad;
  const int npix = bs_y * bs_x;
  unsigned char* base = smem + warp * warp_slice_bytes(bs_y, bs_x, rad);
  int32_t* cur_s = reinterpret_cast<int32_t*>(base);
  uint8_t* win_s = base + npix * 4;

  const int i = b / nbx;
  const int j = b - i * nbx;
  const int my = mvy[b];
  const int mx = mvx[b];
  int oy = i * bs_y + margin - rad + my;
  int ox = j * bs_x + margin - rad + mx;
  if (kProbe == kOneWindow) {
    oy = margin - rad + mvy[0];
    ox = margin - rad + mvx[0];
  }
  oy = min(max(oy, 0), Ph - round8(wh));
  ox = min(max(ox, 0), Pw - round8(ww));

  const int32_t* cur_b = cur + static_cast<size_t>(b) * npix;
  for (int t = lane; t < npix; t += 32) cur_s[t] = cur_b[t];
  if (kProbe != kNoStage) {
    for (int t = lane; t < wh * ww; t += 32) {
      const int r = t / ww;
      const int c = t - r * ww;
      win_s[t] = P[static_cast<size_t>(oy + r) * Pw + ox + c];
    }
  }
  __syncwarp();

  unsigned long long best = ~0ull;
  const int ncand = kProbe == kNoSad ? 1 : K * K;
  for (int cand = lane; cand < ncand; cand += 32) {
    const int a = cand / K;
    const int bb = cand - a * K;
    int s = 0;
    for (int r = 0; r < bs_y; ++r) {
      const uint8_t* wrow = win_s + (a + r) * ww + bb;
      const int32_t* crow = cur_s + r * bs_x;
      for (int c = 0; c < bs_x; ++c) s += abs(crow[c] - int(wrow[c]));
    }
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<uint32_t>(s)) << 32) |
        static_cast<uint32_t>(cand);
    best = key < best ? key : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if (lane == 0) {
    const int cand = static_cast<int>(best & 0xffffffffull);
    dy[b] = my + cand / K - rad;
    dx[b] = mx + cand % K - rad;
    sad[b] = static_cast<int32_t>(best >> 32);
  }
}

template <int kProbe>
int launch(const void* cur, const void* P, const void* mvy, const void* mvx,
           void* dy, void* dx, void* sad, int nby, int nbx, int bs_y,
           int bs_x, int rad, int margin, int Ph, int Pw, void* stream) {
  const int nb = nby * nbx;
  if (nb <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * warp_slice_bytes(bs_y, bs_x, rad);
  const dim3 grid((nb + kWarpsPerBlock - 1) / kWarpsPerBlock);
  patch_refine_kernel<kProbe><<<grid, 32 * kWarpsPerBlock, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cur), static_cast<const uint8_t*>(P),
      static_cast<const int32_t*>(mvy), static_cast<const int32_t*>(mvx),
      static_cast<int32_t*>(dy), static_cast<int32_t*>(dx),
      static_cast<int32_t*>(sad), nby, nbx, bs_y, bs_x, rad, margin, Ph, Pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int patch_refine_launch(const void* cur, const void* P,
                                   const void* mvy, const void* mvx,
                                   void* dy, void* dx, void* sad, int nby,
                                   int nbx, int bs_y, int bs_x, int rad,
                                   int margin, int Ph, int Pw,
                                   void* stream) {
  return launch<kFull>(cur, P, mvy, mvx, dy, dx, sad, nby, nbx, bs_y, bs_x,
                       rad, margin, Ph, Pw, stream);
}

// The cost probe: the same launch for variant 0..3 (Probe above); -1 for
// another value.  Only variant 0 writes right answers.
extern "C" int patch_refine_probe_launch(int variant, const void* cur,
                                         const void* P, const void* mvy,
                                         const void* mvx, void* dy, void* dx,
                                         void* sad, int nby, int nbx,
                                         int bs_y, int bs_x, int rad,
                                         int margin, int Ph, int Pw,
                                         void* stream) {
  switch (variant) {
    case kFull:
      return launch<kFull>(cur, P, mvy, mvx, dy, dx, sad, nby, nbx, bs_y,
                           bs_x, rad, margin, Ph, Pw, stream);
    case kNoStage:
      return launch<kNoStage>(cur, P, mvy, mvx, dy, dx, sad, nby, nbx, bs_y,
                              bs_x, rad, margin, Ph, Pw, stream);
    case kNoSad:
      return launch<kNoSad>(cur, P, mvy, mvx, dy, dx, sad, nby, nbx, bs_y,
                            bs_x, rad, margin, Ph, Pw, stream);
    case kOneWindow:
      return launch<kOneWindow>(cur, P, mvy, mvx, dy, dx, sad, nby, nbx,
                                bs_y, bs_x, rad, margin, Ph, Pw, stream);
    default:
      return -1;
  }
}
