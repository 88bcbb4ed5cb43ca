// The VC-2 low-delay slice search and packing, with the packing shared over
// arith_pool.cpp's threads.
//
// This file includes schro_coding.cpp, which stays the JAX package's coder
// line for line, for its tables, bit writer and DC chains, and is built in
// its place; `ld_encode_tab_pooled` is `ld_encode_tab` (schro_coding.cpp)
// in two phases, the same bytes.
//
// bits_tab/last_tab: (61, n_slices) int32 — total sint bits and last-nonzero
// position of the NON-DC segment at each base index (computed on device by
// pipeline.make_lowdelay_analyze). The host then only runs the DC chains and
// table lookups during the search, and one final quantise pass for packing.
//
// The search runs slice after slice in raster order: a slice's DC residuals
// predict from its neighbours' reconstruction at the bases chosen for them.
// It keeps each slice's base, DC residuals and lengths.  The packing then
// quantises and writes each slice at its own byte offset (the budget fixes
// every slice's size), so the slices' rows are packed on `pool_for`'s
// threads when `helpers` > 0; the bytes are the same either way.

#include <atomic>
#include <vector>

#include "schro_coding.cpp"

extern "C" void pool_for(int n, int helpers, void (*fn)(void* ctx, int i),
                         void* ctx);

namespace {

// What the packing of one slice needs, shared by every slice.
struct LdPackJob {
  const int32_t *yd, *ud, *vd, *y_qmo, *uv_qmo;
  int nx, Sy, Suv, dcs_y, dcs_uv;
  const int64_t* slice_bytes;
  const int64_t* slice_start;    // byte offset of each slice in out
  const int32_t* base;           // per slice: the chosen base index
  const int32_t* y_bits;         // per slice: luma bits at that base
  const int32_t* trail_y;        // per slice: trailing luma zeros
  const int32_t* trail_uv;       // per slice: trailing chroma pair zeros x 2
  const int64_t* dc;             // per slice: dcs_y + 2 dcs_uv DC residuals
  uint8_t* out;
  std::atomic<int> overflow{0};
};

// Quantises v[begin, S) at base less each position's offset, runs of
// equal offset at a time.
void ld_quant_segment(const int32_t* v, const int32_t* qmo, int begin, int S,
                      int base, int64_t* q) {
  for (int seg = begin; seg < S;) {
    int32_t qmo_v = qmo[seg];
    int seg_end = seg;
    while (seg_end < S && qmo[seg_end] == qmo_v) seg_end++;
    int qi = std::min(std::max(base - qmo_v, 0), 60);
    int64_t qf = QUANT_FACTOR[qi], qo = QUANT_OFFSET_1_2[qi];
    int64_t offset = qo - qf / 2;
    uint64_t M = QF_MAGIC[qi].M;
    int Sh = QF_MAGIC[qi].S;
    for (int k = seg; k < seg_end; k++) {
      int64_t x = (int64_t)v[k];
      int64_t a = (x < 0 ? -x : x) << 2;
      int64_t mag = a < qo ? 0
          : (int64_t)(((__uint128_t)(uint64_t)(a - offset) * M) >> Sh);
      q[k] = x < 0 ? -mag : mag;
    }
    seg = seg_end;
  }
}

// Quantises and packs the slices of one row of the slice grid.
void ld_pack_row(void* ctx, int sy) {
  LdPackJob& j = *static_cast<LdPackJob*>(ctx);
  thread_local std::vector<int64_t> qy, qu, qv;
  qy.resize(j.Sy);
  qu.resize(j.Suv);
  qv.resize(j.Suv);
  int n_dc = j.dcs_y + 2 * j.dcs_uv;
  for (int si = sy * j.nx; si < (sy + 1) * j.nx; si++) {
    int base = j.base[si];
    const int64_t* dc = j.dc + (int64_t)si * n_dc;
    for (int k = 0; k < j.dcs_y; k++) qy[k] = dc[k];
    for (int k = 0; k < j.dcs_uv; k++) {
      qu[k] = dc[j.dcs_y + k];
      qv[k] = dc[j.dcs_y + j.dcs_uv + k];
    }
    ld_quant_segment(j.yd + (int64_t)si * j.Sy, j.y_qmo, j.dcs_y, j.Sy,
                     base, qy.data());
    ld_quant_segment(j.ud + (int64_t)si * j.Suv, j.uv_qmo, j.dcs_uv, j.Suv,
                     base, qu.data());
    ld_quant_segment(j.vd + (int64_t)si * j.Suv, j.uv_qmo, j.dcs_uv, j.Suv,
                     base, qv.data());

    int sbytes = (int)j.slice_bytes[si];
    int length_bits = ilog2up(8 * (uint32_t)sbytes);
    int64_t cap_bits = (int64_t)sbytes * 8;
    BitWriter bw;
    bw.init(j.out + j.slice_start[si], sbytes);
    bw.put_bits(7, base);
    bw.put_bits(length_bits, j.y_bits[si] - j.trail_y[si]);
    int ny_coef = j.Sy - j.trail_y[si];
    for (int k = 0; k < ny_coef; k++) bw.put_sint(qy[k]);
    int nuv_pair = j.Suv - j.trail_uv[si] / 2;
    for (int k = 0; k < nuv_pair; k++) {
      bw.put_sint(qu[k]);
      bw.put_sint(qv[k]);
    }
    if (bw.pos > cap_bits) {
      j.overflow.store(1);
      return;
    }
    while (bw.pos < cap_bits) bw.put_bit(1);
  }
}

}  // namespace

extern "C" {

int64_t ld_encode_tab_pooled(
    const int32_t* yd, const int32_t* ud, const int32_t* vd,
    const int32_t* y_qmo, const int32_t* uv_qmo,
    int ny, int nx, int Sy, int Suv,
    int y_bh, int y_bw, int uv_bh, int uv_bw,
    const int32_t* y_ll, const int32_t* u_ll, const int32_t* v_ll,
    int y_llw, int y_llh, int uv_llw, int uv_llh,
    int dc_qm, int deep,
    const int64_t* slice_bytes,
    const int32_t* y_bits_tab, const int32_t* y_last_tab,
    const int32_t* u_bits_tab, const int32_t* u_last_tab,
    const int32_t* v_bits_tab, const int32_t* v_last_tab,
    uint8_t* out, int64_t out_capacity,
    int32_t* chosen_base_out, int helpers) {
  qf_magic_init();
  int dcs_y = y_bh * y_bw;
  int dcs_uv = uv_bh * uv_bw;
  int n_slices = ny * nx;
  int n_dc = dcs_y + 2 * dcs_uv;

  std::vector<int32_t> y_recon((size_t)y_llw * y_llh);
  std::vector<int32_t> u_recon((size_t)uv_llw * uv_llh);
  std::vector<int32_t> v_recon((size_t)uv_llw * uv_llh);
  std::vector<int64_t> dc((size_t)n_slices * n_dc);
  std::vector<int64_t> slice_start(n_slices);
  std::vector<int32_t> y_bits_of(n_slices), trail_y_of(n_slices),
      trail_uv_of(n_slices);

  int64_t total = 0;
  for (int si = 0; si < n_slices; si++) {
    slice_start[si] = total;
    total += slice_bytes[si];
  }
  if (total > out_capacity) return -1;
  memset(out, 0, (size_t)out_capacity);

  int si = 0;
  for (int sy = 0; sy < ny; sy++) {
    for (int sx = 0; sx < nx; sx++, si++) {
      int sbytes = (int)slice_bytes[si];
      int length_bits = ilog2up(8 * (uint32_t)sbytes);
      int64_t* dqy = dc.data() + (int64_t)si * n_dc;
      int64_t* dqu = dqy + dcs_y;
      int64_t* dqv = dqu + dcs_uv;

      int y_bits_f = 0, trail_y_f = 0, trail_uv_f = 0;

      auto estimate = [&](int base) {
        int qi0 = std::min(std::max(base - dc_qm, 0), 60);
        ld_quant_dc_block(y_ll, y_recon.data(), y_llw, sy * y_bh,
                          (sy + 1) * y_bh, sx * y_bw, (sx + 1) * y_bw, qi0,
                          dqy, deep);
        ld_quant_dc_block(u_ll, u_recon.data(), uv_llw, sy * uv_bh,
                          (sy + 1) * uv_bh, sx * uv_bw, (sx + 1) * uv_bw,
                          qi0, dqu, deep);
        ld_quant_dc_block(v_ll, v_recon.data(), uv_llw, sy * uv_bh,
                          (sy + 1) * uv_bh, sx * uv_bw, (sx + 1) * uv_bw,
                          qi0, dqv, deep);

        int dc_bits_y = 0, dc_last_y = -1;
        for (int k = 0; k < dcs_y; k++) {
          dc_bits_y += sint_bits(dqy[k]);
          if (dqy[k]) dc_last_y = k;
        }
        int dc_bits_u = 0, dc_last_u = -1;
        int dc_bits_v = 0, dc_last_v = -1;
        for (int k = 0; k < dcs_uv; k++) {
          dc_bits_u += sint_bits(dqu[k]);
          if (dqu[k]) dc_last_u = k;
          dc_bits_v += sint_bits(dqv[k]);
          if (dqv[k]) dc_last_v = k;
        }

        int64_t ti = (int64_t)base * n_slices + si;
        int y_bits = dc_bits_y + y_bits_tab[ti];
        int ynl = y_last_tab[ti];
        int y_last = ynl >= 0 ? dcs_y + ynl : dc_last_y;
        int trail_y = (y_last >= 0) ? (Sy - 1 - y_last) : Sy;

        int u_bits = dc_bits_u + u_bits_tab[ti];
        int unl = u_last_tab[ti];
        int u_last = unl >= 0 ? dcs_uv + unl : dc_last_u;
        int trail_u = (u_last >= 0) ? (Suv - 1 - u_last) : Suv;
        int v_bits = dc_bits_v + v_bits_tab[ti];
        int vnl = v_last_tab[ti];
        int v_last = vnl >= 0 ? dcs_uv + vnl : dc_last_v;
        int trail_v = (v_last >= 0) ? (Suv - 1 - v_last) : Suv;
        int trail_uv = 2 * std::min(trail_u, trail_v);

        y_bits_f = y_bits;
        trail_y_f = trail_y;
        trail_uv_f = trail_uv;
        return 7 + length_bits + y_bits + u_bits + v_bits - trail_y - trail_uv;
      };

      // the last estimate is at the chosen base: its DC residuals and
      // reconstruction are the slice's
      int base;
      int n_est = estimate(0);
      if (n_est <= sbytes * 8) {
        base = 0;
      } else {
        int i = 0;
        for (int size = 32; size >= 1; size >>= 1) {
          n_est = estimate(i + size);
          if (n_est >= sbytes * 8) i += size;
        }
        estimate(i + 1);
        base = i + 1;
      }
      chosen_base_out[si] = base;
      y_bits_of[si] = y_bits_f;
      trail_y_of[si] = trail_y_f;
      trail_uv_of[si] = trail_uv_f;
    }
  }

  LdPackJob job;
  job.yd = yd; job.ud = ud; job.vd = vd;
  job.y_qmo = y_qmo; job.uv_qmo = uv_qmo;
  job.nx = nx; job.Sy = Sy; job.Suv = Suv;
  job.dcs_y = dcs_y; job.dcs_uv = dcs_uv;
  job.slice_bytes = slice_bytes;
  job.slice_start = slice_start.data();
  job.base = chosen_base_out;
  job.y_bits = y_bits_of.data();
  job.trail_y = trail_y_of.data();
  job.trail_uv = trail_uv_of.data();
  job.dc = dc.data();
  job.out = out;
  pool_for(ny, helpers, ld_pack_row, &job);
  return job.overflow.load() ? -1 : total;
}

}  // extern "C"
