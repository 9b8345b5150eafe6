// Fused atom-blocked attention backward for Hopper (sm_90a), float32.
//
// Replaces the two Pallas backward kernels of
// x2gnn_tpu/ops/pallas/blocked_attn.py: `_bwd_kernel` (:198) and
// `_bwd_kernel_ichunk` (:346), which computes the same function with the
// query axis tiled for the TPU's 16 MB VMEM, with their two static
// branches: HAS_DROP (the forward's keep mask, :254-255, :423-424) and
// WANT_ALPHA (the cotangent galpha of the forward's alpha output,
// :256-257, :425-426). One kernel covers both: any DI, DK <= 64, HC = H*C
// with C dividing 32 (HC a multiple of 32 up to 1024), L <= kMaxL and any
// K whose W and rbf rows fit shared memory. The branches are template
// flags, four instances (drop, galpha) in {0,1}^2, so the instance without
// them is the kernel measured below.
//
// Forward (blocked_attn_fwd.cu), per atom n, with kk = k + e, vv = v + e:
//   alpha(i,k,h) = softmax_k over valid pairs of q[i].kk[k] / sqrt(C)
//   s(i,k,:)     = bias + sum_l pref_l P_l(z[i,k]) G[k,l,:]
//   G[k,l,:]     = sum_n rbf[k, l*K+n] W[l*K+n, :]
//   out[i,:]     = sum_k alpha(i,k,h) vv[k,:] s(i,k,:)
// With the mask, out[i,:] = sum_k alpha drop vv s; the alpha output is
// the undropped alpha. Backward from g = d out (N, DI, HC), galpha = d
// alpha (0 without it) and the saved forward output:
//   ds(i,k,c)     = g vv alpha drop
//   dv[k,c]       = sum_i g s alpha drop
//   dalpha(i,k,h) = drop sum_{c in h} g vv s + galpha
//   inner(i,h)    = sum_k alpha dalpha
//                 = sum_{c in h} g(i,c) out(i,c) + sum_k alpha galpha
//   dscore        = alpha (dalpha - inner) / sqrt(C), 0 at invalid pairs
//   dq[i] = sum_k dscore kk[k],  dk[k] = sum_i dscore q[i]
//   de    = sum_k (dk + dv)                     (e is added to k and v)
//   dW[l*K+n, c] = sum_{atoms,k} rbf[k, l*K+n] pref_l sum_i P_l ds
//   db[c]        = sum_{atoms,i,k} ds
// No float atomics: each CTA writes one (L*K + 1, HC) partial of dW and db
// for all its atoms, and blocked_attn_bwd_reduce sums the partials in an
// order fixed by the shape, so two runs give bitwise-equal dW and db.
//
// Bound at the training shape (flagship X2GNN, 32 QM9-scale molecules,
// N=760, DI=DK=32, H=16, C=8, L=7, K=6), counted as chip_smoke.py counts
// it: the input rows the gradients depend on read once (q and g at query
// slots in a valid pair, k, v and rbf at key slots in a valid pair, z at
// valid pairs, e of atoms with one, all ids, W and bias; about 27% of the
// padded rows) and each gradient written whole once, 52.9 MB, 0.0158 ms
// at 3.35 TB/s (reading the saved forward output's live rows, as this
// design does instead of recomputing it, adds 3.3 MB: 0.0168 ms); the
// FP32 operations of its ~75k valid pairs, 0.009 ms at 67 TFLOP/s. So it
// is bound by bytes, and what held
// the first design (1.593 ms on an H100 80GB HBM3 at 700 W) far from that
// bound was latency: one CTA of 4 warps per
// SM (119 KB of shared memory per atom), long dependent chains per pair
// (three head-sum shuffles, two exps, five divisions of the Legendre
// recurrence) repeated in three passes by all 128 channel threads, and a
// pass that only rebuilt the forward output.
//
// What this design does about each:
// - The forward output is saved by the autograd Function and read here:
//   inner(i,h) is one head sum of g*out per query, so the pass that
//   rebuilt the output is gone.
// - Only the atom's valid slots are walked: warp 0 compacts the valid
//   query and key slots with ballots; an atom with no valid pair (pad
//   atoms, degree 0/1) writes its zeros and is done (a CTA-uniform exit).
// - Each thing is computed once per atom and query chunk, not per channel
//   thread and pass: pref_l P_l(z) once per valid pair (threads over
//   pairs, reciprocal constants instead of divisions, kept in shared
//   memory, read back with 16-byte loads); each pair-head score once (a
//   head-sum butterfly) and its exp once (threads over (query, head)
//   pairs, two passes over the keys in shared memory, alpha stored in
//   place of the score); G_k once per key, in registers during the
//   gradient pass, from W and the atom's rbf rows in shared memory (W is
//   read from device memory once per CTA).
// - Parallelism and occupancy: a CTA is up to 4 warpgroups, each one
//   thread per channel of a group of up to 128 channels (heads never
//   straddle a group, so a wider HC is more CTAs along grid.y); the
//   warpgroups split each atom's keys (the score and gradient passes),
//   each with its own dk/dv/dG registers, and add their dq, de and dW/db
//   shares in warpgroup order. One CTA of 16 warps per SM, registers
//   capped at 128 by __launch_bounds__, shared memory for one query chunk
//   sized by the Python launch plan (ops/blocked_attn.py, bwd_plan). The
//   queries are chunked as on the TPU, for the same reason (fast memory),
//   and at D=48 as at D=32 the CTA keeps its 16 warps.
// - Persistent CTAs: R = min(N, 132) CTAs (a function of N only) walk the
//   atoms n = r, r + R, ...; each keeps its dW/db partial over all its
//   atoms and writes it once: R rows instead of N. dW is L x K values per
//   channel in registers for K <= kRegK; for a larger K, L*K rows per
//   warpgroup in shared memory (the plan gives fewer warpgroups where four
//   do not fit), so the kernel takes any K that fits.
// - The reduce reads 16 bytes per load, four independent accumulators per
//   thread over 32 row lanes, in 8-column CTAs: 172 CTAs for HC=128,
//   L*K=42.
// - The mask and galpha: the gradient pass reads the pair's mask
//   value and galpha at its uncompacted (i, k) slot, one 4-byte load each
//   per (query, key) step that the head's C lanes share; the softmax's
//   thread per (query, head) adds sum_k alpha galpha over the valid pairs
//   to inner. Shared memory and the launch plan are unchanged. Each adds
//   4 B per valid pair and head to the bound, and a few operations per
//   pair and head; measured beside the instance without them by
//   chip_smoke.py (phase 9a; PERF.md section 6).
// Measured by chip_smoke.py on "NVIDIA H100 80GB HBM3, 700.00 W": 0.2676
// ms per launch at N=760, D=32 (16.9x its 0.0158 ms bound; the first
// design 1.5930) and 0.4801 ms at N=328, D=48 (37.0x its 0.0130 ms bound,
// set there by the operations;
// the first design 3.2393), 0.4258 ms at N=760, D=32 with K=9 (dW in
// shared memory); 16 resident warps per SM, 128 registers with 8 bytes of
// local memory per thread; the reduce 0.0032 ms on 132 x 5,504 partials,
// partial.sum(0) 0.0050 ms.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxL = 8;        // Legendre orders a thread keeps
// radial functions per order whose dW a thread keeps in registers; for a
// larger K each warpgroup keeps its dW in shared memory instead
constexpr int kRegK = 6;
constexpr int kMaxDegree = 64;  // DI, DK: two 32-slot ballots
constexpr int kGroupThreads = 128;   // one thread per channel of a group
constexpr int kMaxWarpgroups = 4;    // warpgroups of a CTA split the keys
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one CTA
constexpr float kNeg = -1e30f;
constexpr double kPi = 3.14159265358979323846;
// reduce: 8 float4 columns x 32 row lanes, 4 accumulators per thread
constexpr int kRedCols = 8;
constexpr int kRedRows = 32;
constexpr int kRedAcc = 4;

__constant__ float kInv[kMaxL] = {0.f, 1.f, 1.f / 2, 1.f / 3,
                                  1.f / 4, 1.f / 5, 1.f / 6, 1.f / 7};

__device__ __forceinline__ float head_sum(float x, int C) {
  // C-lane groups are aligned inside a warp (C divides 32); the xor
  // butterfly leaves every lane of a group with the same sum, bit for bit
  for (int off = C >> 1; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// channels of a warpgroup: the largest of 128, 96, 64, 32 that divides HC
__host__ __device__ inline int group_threads(int HC) {
  for (int t = kGroupThreads; t > 32; t -= 32) {
    if (HC % t == 0) return t;
  }
  return 32;
}

struct Layout {
  size_t qidx, qa, kidx, kb, pref, cnt, de, w, rbf, dws, q, g, dq, al, p,
      inner, red, bytes;
};

__host__ __device__ inline size_t up4(size_t words) {
  return (words + 3) & ~static_cast<size_t>(3);   // 16-byte aligned regions
}

// Shared memory of one CTA of WG warpgroups of TB threads, in 4-byte
// words; ops/blocked_attn.py's bwd_plan computes the same byte count.
// The chunk's arrays and the final dW/db reduction share one region.
__host__ __device__ inline Layout make_layout(int DI, int DK, int TB, int WG,
                                              int C, int L, int K, int IC) {
  const size_t Hb = TB / C;
  const size_t LK = static_cast<size_t>(L) * K;
  Layout s{};
  size_t off = 0;
  s.qidx = off;  off += up4(DI);     // compacted valid query slots
  s.qa = off;    off += up4(DI);     // and their source atoms
  s.kidx = off;  off += up4(DK);     // compacted valid key slots
  s.kb = off;    off += up4(DK);     // and their destination atoms
  s.pref = off;  off += kMaxL;
  s.cnt = off;   off += 8;   // nI, nK, query mask, key mask (2 words each)
  s.de = off;    off += static_cast<size_t>(WG) * TB;   // de per warpgroup
  s.w = off;     off += LK * TB;     // the group's W columns, per CTA
  s.rbf = off;   off += up4(DK * LK);   // the atom's valid keys' rbf rows
  s.dws = off;   // dW per warpgroup over all its atoms, when K > kRegK
  if (K > kRegK) off += static_cast<size_t>(WG) * LK * TB;
  const size_t base = off;
  s.q = off;     off += static_cast<size_t>(IC) * TB;   // chunk's q rows
  s.g = off;     off += static_cast<size_t>(IC) * TB;   // chunk's g rows
  s.dq = off;    off += static_cast<size_t>(WG) * IC * TB;   // per wg
  s.al = off;    off += up4(IC * DK * Hb);   // score, then alpha (i,key,h)
  s.p = off;     off += static_cast<size_t>(IC) * DK * kMaxL;  // pref_l P_l
  s.inner = off; off += up4(IC * Hb);
  s.red = base;
  const size_t red_end = base + (LK + 1) * TB;
  s.bytes = (off > red_end ? off : red_end) * 4;
  return s;
}

// DROP and GALPHA are the reference's HAS_DROP and WANT_ALPHA (:198-259):
// the forward's keep mask, and the cotangent of its alpha output. Without
// them the instance is the kernel measured below, its registers and
// occupancy unchanged.
template <bool DROP, bool GALPHA>
__global__ void __launch_bounds__(kGroupThreads * kMaxWarpgroups, 1)
blocked_attn_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ e,
    const float* __restrict__ rbf, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ z,
    const int* __restrict__ a_ids, const int* __restrict__ b_ids,
    const float* __restrict__ drop, const float* __restrict__ out,
    const float* __restrict__ g, const float* __restrict__ galpha,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ de, float* __restrict__ partial, int N, int DI,
    int DK, int HC, int TB, int C, int L, int K, int IC, float rsc) {
  extern __shared__ float smem[];
  const int NT = blockDim.x;                // WG warpgroups of TB threads
  const int WG = NT / TB;
  const Layout lay = make_layout(DI, DK, TB, WG, C, L, K, IC);
  int* qidx = reinterpret_cast<int*>(smem + lay.qidx);
  int* qa = reinterpret_cast<int*>(smem + lay.qa);
  int* kidx = reinterpret_cast<int*>(smem + lay.kidx);
  int* kb = reinterpret_cast<int*>(smem + lay.kb);
  float* pref_s = smem + lay.pref;
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + lay.cnt);
  float* de_s = smem + lay.de;
  float* w_s = smem + lay.w;
  float* rbf_s = smem + lay.rbf;
  float* q_s = smem + lay.q;
  float* g_s = smem + lay.g;
  float* al_s = smem + lay.al;
  float* p_s = smem + lay.p;
  float* inner_s = smem + lay.inner;

  const int tid = threadIdx.x;
  const int wg = tid / TB;                  // this thread's warpgroup
  const int lt = tid - wg * TB;
  const int hc = blockIdx.y * TB + lt;      // its channel
  const int Hb = TB / C;
  const int hb = lt / C;                    // its head within the group
  const int c = lt - hb * C;
  const int lane = tid & 31;
  const int LK = L * K;
  const int H = HC / C;                     // heads of the pair arrays
  const int hg = blockIdx.y * Hb + hb;      // this thread's head
  float* dq_w = smem + lay.dq + static_cast<size_t>(wg) * IC * TB;
  const float bv = bias[hc];
  if (tid < L) {
    // same float32 value as the reference's f64 numpy prefactor
    pref_s[tid] = static_cast<float>(sqrt((2.0 * tid + 1.0) / (4.0 * kPi)));
  }
  for (int t = tid; t < LK * TB; t += NT) {   // W: read once per CTA
    const int r = t / TB;
    w_s[t] = w[static_cast<size_t>(r) * HC + blockIdx.y * TB + (t - r * TB)];
  }

  // dW partial of channel hc over this warpgroup's keys: in registers
  // (dw) for K <= kRegK, else in the warpgroup's rows of shared memory (dws)
  const bool dw_regs = K <= kRegK;
  float* dws = smem + lay.dws + static_cast<size_t>(wg) * LK * TB;
  float dw[kMaxL][kRegK];
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
    for (int t = 0; t < kRegK; ++t) dw[l][t] = 0.f;
  }
  if (!dw_regs) {
    for (int r = 0; r < LK; ++r) dws[r * TB + lt] = 0.f;
  }
  float db = 0.f;

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    __syncthreads();   // the previous atom is done with shared memory
    // ---- compact the valid query and key slots (warp 0, ballots) ----
    if (tid < 32) {
      int cntI = 0, cntK = 0;
      for (int base = 0; base < kMaxDegree; base += 32) {
        const int i = base + lane;
        const int a = i < DI ? a_ids[static_cast<size_t>(n) * DI + i] : -1;
        const unsigned mi = __ballot_sync(0xffffffffu, a >= 0);
        if (a >= 0) {
          const int slot = cntI + __popc(mi & ((1u << lane) - 1u));
          qidx[slot] = i;
          qa[slot] = a;
        }
        cntI += __popc(mi);
        const int b = i < DK ? b_ids[static_cast<size_t>(n) * DK + i] : -1;
        const unsigned mk = __ballot_sync(0xffffffffu, b >= 0);
        if (b >= 0) {
          const int slot = cntK + __popc(mk & ((1u << lane) - 1u));
          kidx[slot] = i;
          kb[slot] = b;
        }
        cntK += __popc(mk);
        if (lane == 0) {
          cnt[2 + base / 32] = mi;
          cnt[4 + base / 32] = mk;
        }
      }
      if (lane == 0) {
        cnt[0] = cntI;
        cnt[1] = cntK;
      }
    }
    __syncthreads();
    const int nI = cnt[0], nK = cnt[1];
    int any = 0;
    for (int t = tid; t < nI * nK; t += NT) any |= qa[t / nK] != kb[t % nK];
    any = __syncthreads_or(any);

    // ---- zeros at pad slots (every slot if no pair is valid) ----
    for (int i = wg; i < DI; i += WG) {
      if (!any || !((cnt[2 + (i >> 5)] >> (i & 31)) & 1u)) {
        dq[(static_cast<size_t>(n) * DI + i) * HC + hc] = 0.f;
      }
    }
    for (int j = wg; j < DK; j += WG) {
      if (!any || !((cnt[4 + (j >> 5)] >> (j & 31)) & 1u)) {
        const size_t off = (static_cast<size_t>(n) * DK + j) * HC + hc;
        dk[off] = 0.f;
        dv[off] = 0.f;
      }
    }
    if (!any) {   // uniform over the CTA
      if (wg == 0) de[static_cast<size_t>(n) * HC + hc] = 0.f;
      continue;
    }

    for (int t = tid; t < nK * LK; t += NT) {   // the valid keys' rbf rows
      const int jj = t / LK;
      rbf_s[t] = rbf[(static_cast<size_t>(n) * DK + kidx[jj]) * LK
                     + (t - jj * LK)];
    }
    const float ev = e[static_cast<size_t>(n) * HC + hc];
    float de_acc = 0.f;
    for (int i0 = 0; i0 < nI; i0 += IC) {
      const int icnt = min(IC, nI - i0);
      // ---- the chunk's q, g rows; inner(i,h) = sum_{c in h} g out ----
      for (int ii = wg; ii < icnt; ii += WG) {
        const size_t off =
            (static_cast<size_t>(n) * DI + qidx[i0 + ii]) * HC + hc;
        const float gi = g[off];
        q_s[ii * TB + lt] = q[off];
        g_s[ii * TB + lt] = gi;
        const float inner = head_sum(gi * out[off], C);
        if (c == 0) inner_s[ii * Hb + hb] = inner;
      }
      for (int ii = 0; ii < icnt; ++ii) dq_w[ii * TB + lt] = 0.f;
      // ---- pref_l P_l(z) once per pair of the chunk ----
      for (int t = tid; t < icnt * nK; t += NT) {
        const int ii = t / nK;
        const int jj = t - ii * nK;
        const float zz = z[(static_cast<size_t>(n) * DI + qidx[i0 + ii]) * DK
                           + kidx[jj]];
        float* p = p_s + (ii * DK + jj) * kMaxL;
        float p0 = 1.f, p1 = zz;
        p[0] = pref_s[0];
        if (L > 1) p[1] = pref_s[1] * zz;
        for (int l = 2; l < L; ++l) {
          const float p2 = ((2 * l - 1) * zz * p1 - (l - 1) * p0) * kInv[l];
          p[l] = pref_s[l] * p2;
          p0 = p1;
          p1 = p2;
        }
      }
      __syncthreads();   // q_s rows staged by other warpgroups
      // ---- each pair-head score once; the keys split over warpgroups ----
      float kn = 0.f;
      if (wg < nK) kn = k[(static_cast<size_t>(n) * DK + kidx[wg]) * HC + hc];
      for (int jj = wg; jj < nK; jj += WG) {
        const float kj = kn + ev;
        if (jj + WG < nK) {   // the warpgroup's next key, loaded early
          kn = k[(static_cast<size_t>(n) * DK + kidx[jj + WG]) * HC + hc];
        }
        const int bj = kb[jj];
#pragma unroll 4
        for (int ii = 0; ii < icnt; ++ii) {
          const float sc = head_sum(q_s[ii * TB + lt] * kj, C) * rsc;
          if (c == 0) {
            al_s[(ii * DK + jj) * Hb + hb] = qa[i0 + ii] == bj ? kNeg : sc;
          }
        }
      }
      __syncthreads();
      // ---- softmax per (query, head): each exp once; alpha in place.
      // GALPHA adds sum_k alpha galpha to inner (the alpha output's share
      // of sum_k alpha dalpha), galpha read at the valid pairs' uncompacted
      // (i, k) slots ----
      for (int t = tid; t < icnt * Hb; t += NT) {
        const int ii = t / Hb;
        const int h = t - ii * Hb;
        float* row = al_s + ii * DK * Hb + h;
        float m = kNeg / 2;
        for (int jj = 0; jj < nK; ++jj) m = fmaxf(m, row[jj * Hb]);
        float l = 0.f;
        for (int jj = 0; jj < nK; ++jj) {
          const float ex = expf(row[jj * Hb] - m);   // 0 at invalid pairs
          row[jj * Hb] = ex;
          l += ex;
        }
        const float rl = 1.f / fmaxf(l, 1e-16f);
        float ag = 0.f;
        const size_t prow =
            (static_cast<size_t>(n) * DI + qidx[i0 + ii]) * DK;
        for (int jj = 0; jj < nK; ++jj) {
          const float a = row[jj * Hb] * rl;
          row[jj * Hb] = a;
          if constexpr (GALPHA) {
            if (kb[jj] != qa[i0 + ii]) {
              ag = fmaf(a, galpha[(prow + kidx[jj]) * H + blockIdx.y * Hb
                                  + h], ag);
            }
          }
        }
        if constexpr (GALPHA) inner_s[ii * Hb + h] += ag;
      }
      __syncthreads();
      // ---- key-outer gradients, the keys split over warpgroups: G_k,
      // dG_k, dk_k, dv_k in registers; an invalid pair has alpha exactly 0
      // and adds exact zeros ----
      float vn = 0.f;
      kn = 0.f;
      if (wg < nK) {
        const size_t koff =
            (static_cast<size_t>(n) * DK + kidx[wg]) * HC + hc;
        kn = k[koff] + ev;
        vn = v[koff] + ev;
      }
      for (int jj = wg; jj < nK; jj += WG) {
        const float kj = kn, vj = vn;
        if (jj + WG < nK) {   // the warpgroup's next key, loaded early
          const size_t noff =
              (static_cast<size_t>(n) * DK + kidx[jj + WG]) * HC + hc;
          kn = k[noff] + ev;
          vn = v[noff] + ev;
        }
        const size_t koff =
            (static_cast<size_t>(n) * DK + kidx[jj]) * HC + hc;
        const float* rb = rbf_s + jj * LK;
        float G[kMaxL], dG[kMaxL];
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
          float acc = 0.f;
          if (l < L && dw_regs) {
#pragma unroll
            for (int t = 0; t < kRegK; ++t) {
              if (t < K) {
                acc = fmaf(rb[l * K + t], w_s[(l * K + t) * TB + lt], acc);
              }
            }
          } else if (l < L) {
            for (int t = 0; t < K; ++t) {
              acc = fmaf(rb[l * K + t], w_s[(l * K + t) * TB + lt], acc);
            }
          }
          G[l] = acc;
          dG[l] = 0.f;
        }
        float dk_acc = 0.f, dv_acc = 0.f;
        // the pair (i, k, h) at ((n * DI + i) * DK + k) * H + hg
        const size_t kcol = static_cast<size_t>(kidx[jj]) * H + hg;
        for (int ii = 0; ii < icnt; ++ii) {
          const float alpha = al_s[(ii * DK + jj) * Hb + hb];
          // the message's weight alpha * drop, the mask and the alpha
          // cotangent of the pair (1 and 0 without them)
          float am = alpha, dr = 1.f, ga = 0.f;
          if constexpr (DROP || GALPHA) {
            const size_t at =
                (static_cast<size_t>(n) * DI + qidx[i0 + ii]) * DK * H + kcol;
            if constexpr (DROP) {
              dr = drop[at];
              am = alpha * dr;
            }
            if constexpr (GALPHA) ga = galpha[at];
          }
          // pref_l P_l of the pair, two 16-byte loads
          const float4* pp =
              reinterpret_cast<const float4*>(p_s + (ii * DK + jj) * kMaxL);
          const float4 p0 = pp[0], p1 = pp[1];
          const float P[kMaxL] = {p0.x, p0.y, p0.z, p0.w,
                                  p1.x, p1.y, p1.z, p1.w};
          float s = bv;
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
            if (l < L) s = fmaf(P[l], G[l], s);
          }
          const float gi = g_s[ii * TB + lt];
          const float qi = q_s[ii * TB + lt];
          const float ds = gi * vj * am;
          dv_acc = fmaf(gi * s, am, dv_acc);
          float dalpha = head_sum(gi * vj * s, C);
          if constexpr (DROP) dalpha *= dr;      // :254-255
          if constexpr (GALPHA) dalpha += ga;    // :256-257
          const float dsc = alpha * (dalpha - inner_s[ii * Hb + hb]) * rsc;
          dq_w[ii * TB + lt] = fmaf(dsc, kj, dq_w[ii * TB + lt]);
          dk_acc = fmaf(dsc, qi, dk_acc);
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
            if (l < L) dG[l] = fmaf(P[l], ds, dG[l]);
          }
          db += ds;
        }
        if (i0 == 0) {
          dk[koff] = dk_acc;
          dv[koff] = dv_acc;
        } else {   // later chunks add to what this thread wrote before
          dk[koff] += dk_acc;
          dv[koff] += dv_acc;
        }
        de_acc += dk_acc + dv_acc;
        if (dw_regs) {
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
            for (int t = 0; t < kRegK; ++t) {
              if (l < L && t < K) {
                dw[l][t] = fmaf(rb[l * K + t], dG[l], dw[l][t]);
              }
            }
          }
        } else {
#pragma unroll
          for (int l = 0; l < kMaxL; ++l) {
            if (l < L) {
              for (int t = 0; t < K; ++t) {
                float* d = dws + (l * K + t) * TB + lt;
                *d = fmaf(rb[l * K + t], dG[l], *d);
              }
            }
          }
        }
      }
      __syncthreads();
      // ---- dq rows: the warpgroups' shares added in warpgroup order ----
      const float* dq_all = smem + lay.dq;
      for (int ii = wg; ii < icnt; ii += WG) {
        float acc = dq_all[ii * TB + lt];
        for (int u = 1; u < WG; ++u) {
          acc += dq_all[(static_cast<size_t>(u) * IC + ii) * TB + lt];
        }
        dq[(static_cast<size_t>(n) * DI + qidx[i0 + ii]) * HC + hc] = acc;
      }
      __syncthreads();   // before the next chunk overwrites the chunk area
    }
    de_s[tid] = de_acc;
    __syncthreads();
    if (wg == 0) {
      float acc = de_s[lt];
      for (int u = 1; u < WG; ++u) acc += de_s[u * TB + lt];
      de[static_cast<size_t>(n) * HC + hc] = acc;
    }
  }

  // ---- one partial per CTA: the warpgroups' dW and db added in
  // warpgroup order, then its dW rows and its db row ----
  float* red = smem + lay.red;
  for (int u = 1; u < WG; ++u) {
    __syncthreads();
    if (wg == u) {
      if (dw_regs) {
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
          for (int t = 0; t < kRegK; ++t) {
            if (l < L && t < K) red[(l * K + t) * TB + lt] = dw[l][t];
          }
        }
      }
      red[LK * TB + lt] = db;
    }
    __syncthreads();
    if (wg == 0) {
      if (dw_regs) {
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
          for (int t = 0; t < kRegK; ++t) {
            if (l < L && t < K) dw[l][t] += red[(l * K + t) * TB + lt];
          }
        }
      } else {   // warpgroup 0's rows += warpgroup u's rows
        const float* du = smem + lay.dws + static_cast<size_t>(u) * LK * TB;
        for (int r = 0; r < LK; ++r) dws[r * TB + lt] += du[r * TB + lt];
      }
      db += red[LK * TB + lt];
    }
  }
  if (wg != 0) return;
  float* part = partial + static_cast<size_t>(blockIdx.x) * (LK + 1) * HC;
  if (dw_regs) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
      for (int t = 0; t < kRegK; ++t) {
        if (l < L && t < K) {
          part[static_cast<size_t>(l * K + t) * HC + hc] = dw[l][t];
        }
      }
    }
  } else {
    for (int r = 0; r < LK; ++r) {
      part[static_cast<size_t>(r) * HC + hc] = dws[r * TB + lt];
    }
  }
  part[static_cast<size_t>(LK) * HC + hc] = db;
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// out[col] = sum over rows of partial[row, col], four columns per thread.
// Block (kRedCols, kRedRows): lane x owns 4 columns, lane y the rows
// y + 32 (kRedAcc * s + u), summed into accumulator u; the accumulators add
// in u order, then the 32 row lanes in y order. The order depends only on
// the shape, so the sum is the same bit for bit run to run.
__global__ void reduce_rows_kernel(const float4* __restrict__ partial,
                                   float4* __restrict__ out, int rows,
                                   int cols4) {
  __shared__ float4 red[kRedRows][kRedCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kRedCols + tx;
  float4 acc[kRedAcc];
#pragma unroll
  for (int u = 0; u < kRedAcc; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < cols4) {
    for (int r = ty; r < rows; r += kRedAcc * kRedRows) {
#pragma unroll
      for (int u = 0; u < kRedAcc; ++u) {
        const int rr = r + u * kRedRows;
        if (rr < rows) {
          add4(acc[u], partial[static_cast<size_t>(rr) * cols4 + col]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 1; u < kRedAcc; ++u) add4(acc[0], acc[u]);
  red[ty][tx] = acc[0];
  __syncthreads();
  if (ty == 0 && col < cols4) {
    float4 t = red[0][tx];
    for (int y = 1; y < kRedRows; ++y) add4(t, red[y][tx]);
    out[col] = t;
  }
}

bool plan_ok(int N, int DI, int DK, int HC, int C, int L, int K, int grid,
             int threads, int warpgroups, int i_chunk, int smem_bytes) {
  if (N < 1 || DI < 1 || DI > kMaxDegree || DK < 1 || DK > kMaxDegree) {
    return false;
  }
  if (C < 1 || 32 % C || HC % 32 || HC > 1024 || L < 1 || L > kMaxL ||
      K < 1) {
    return false;
  }
  if (threads != group_threads(HC) || warpgroups < 1 ||
      warpgroups > kMaxWarpgroups || grid < 1 || grid > N || i_chunk < 1 ||
      i_chunk > DI) {
    return false;
  }
  const Layout lay =
      make_layout(DI, DK, threads, warpgroups, C, L, K, i_chunk);
  return smem_bytes == static_cast<int>(lay.bytes) && smem_bytes <= kMaxSmem;
}

using BwdKernel = decltype(&blocked_attn_bwd_kernel<false, false>);

// the instance of variant 0..3: (drop, galpha) = (0,0), (1,0), (0,1), (1,1)
BwdKernel bwd_instance(int variant) {
  switch (variant) {
    case 1: return blocked_attn_bwd_kernel<true, false>;
    case 2: return blocked_attn_bwd_kernel<false, true>;
    case 3: return blocked_attn_bwd_kernel<true, true>;
    default: return blocked_attn_bwd_kernel<false, false>;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape or launch plan the kernel does not
// take. All pointers are device pointers to contiguous arrays:
// q/out/g/dq (N,DI,HC), k/v/dk/dv (N,DK,HC), e/de (N,HC), rbf (N,DK,L*K),
// w (L*K,HC), bias (HC), z (N,DI,DK), a_ids (N,DI) int32, b_ids (N,DK)
// int32, partial (grid, L*K+1, HC): per CTA, its dW rows then its db row;
// drop (N,DI,DK,H), the forward's keep mask pre-scaled by 1/keep, and
// galpha (N,DI,DK,H), the cotangent of its alpha output, are nullable: a
// null one leaves its branch out (its own instance). The plan (grid,
// threads, warpgroups, i_chunk, smem_bytes) is ops/blocked_attn.py's
// bwd_plan for the shape.
int blocked_attn_bwd(const float* q, const float* k, const float* v,
                     const float* e, const float* rbf, const float* w,
                     const float* bias, const float* z, const int* a_ids,
                     const int* b_ids, const float* drop, const float* out,
                     const float* g, const float* galpha, float* dq,
                     float* dk, float* dv, float* de, float* partial, int N,
                     int DI, int DK, int H, int C, int L, int K, int grid,
                     int threads, int warpgroups, int i_chunk,
                     int smem_bytes, void* stream) {
  const int HC = H * C;
  if (!plan_ok(N, DI, DK, HC, C, L, K, grid, threads, warpgroups, i_chunk,
               smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdKernel kern =
      bwd_instance((drop != nullptr) + 2 * (galpha != nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(grid, HC / threads), threads * warpgroups, smem_bytes,
         static_cast<cudaStream_t>(stream)>>>(
      q, k, v, e, rbf, w, bias, z, a_ids, b_ids, drop, out, g, galpha, dq,
      dk, dv, de, partial, N, DI, DK, HC, threads, C, L, K, i_chunk,
      static_cast<float>(1.0 / sqrt(static_cast<double>(C))));
  return static_cast<int>(cudaGetLastError());
}

// info[0..3] = registers per thread, local (spill) bytes per thread, static
// shared bytes, and resident CTAs per SM of the gradient kernel's instance
// `variant` (0..3, as bwd_instance) at `threads` threads and `smem_bytes`
// of dynamic shared memory.
int blocked_attn_bwd_occupancy(int threads, int smem_bytes, int variant,
                               int* info) {
  const BwdKernel kern = bwd_instance(variant);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, threads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = blocks;
  return 0;
}

// out (cols) = partial (rows, cols) summed over rows in a fixed order;
// cols a multiple of 4 and both pointers 16-byte aligned.
int blocked_attn_bwd_reduce(const float* partial, float* out, int rows,
                            int cols, void* stream) {
  if (rows < 1 || cols < 4 || cols % 4 ||
      reinterpret_cast<size_t>(partial) % 16 ||
      reinterpret_cast<size_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols4 = cols / 4;
  const dim3 block(kRedCols, kRedRows);
  const dim3 grid((cols4 + kRedCols - 1) / kRedCols);
  reduce_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out),
      rows, cols4);
  return static_cast<int>(cudaGetLastError());
}

const char* blocked_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
