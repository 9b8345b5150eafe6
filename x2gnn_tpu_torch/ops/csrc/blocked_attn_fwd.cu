// Fused atom-blocked attention forward for Hopper (sm_90a), float32 math
// on float32 or bfloat16 storage.
//
// Replaces the two Pallas forward kernels of
// x2gnn_tpu/ops/pallas/blocked_attn.py: `_fwd_kernel` (:166, math in
// `_attention_core` :107) and `_fwd_kernel_ichunk` (:282), which computes
// the same function with the query axis tiled for the TPU's 16 MB VMEM,
// with their two static branches: HAS_DROP (a keep mask, :146, :166-195)
// and WANT_ALPHA (the pre-dropout weights as a second output, :194-195).
// One kernel covers both: any DI, DK <= 64, HC = H*C with C dividing 32
// (HC a multiple of 32 up to 1024), L <= kMaxL and any K whose W and rbf
// rows fit shared memory. The branches are template flags, four instances
// (drop, alpha) in {0,1}^2, so the instance without them is the kernel
// measured below; each in two storage types of q, k, v and e (float or
// __nv_bfloat16, the reference's bf16 storage, :179-182): eight instances.
//
// For one atom n (out-edges k of the atom, in-edges i):
//   kk = k + e, vv = v + e                                  (per channel)
//   valid(i,k) = a_id[i] != b_id[k] && a_id[i] >= 0 && b_id[k] >= 0
//   score(i,k,h) = sum_{c in head h} q[i,c] kk[k,c] / sqrt(C)
//   m(i,h) = max(max_k valid score, -5e29); ex = exp(score - m), 0 if invalid
//   G[k,l,:] = sum_n rbf[k, l*K+n] W[l*K+n, :]               (W un-expanded)
//   s(i,k,:) = bias + sum_l pref_l P_l(z[i,k]) G[k,l,:]
//   out[i,:] = sum_k vv[k,:] s(i,k,:) ex(i,k,h) drop(i,k,h)
//              / max(sum_k ex(i,k,h), 1e-16)        (drop = 1 without it)
//   alpha(i,k,h) = ex(i,k,h) / max(sum_k ex(i,k,h), 1e-16)   (if asked)
// Fully masked rows (pad atoms, pad slots, degree-0/1 atoms) give exactly 0,
// in out and in alpha.
//
// Two devices of the TPU kernel exist only for its 128x128 matrix unit and
// are dropped: the head-indicator matmuls (the per-head sum over C
// channels is one thread's C-deep dot product) and the block-diagonal
// W_bd, which is 7/8 zeros (G is a K-deep FMA chain over the un-expanded
// (L*K, HC) weight).
//
// Bound, counted as chip_smoke.py's attention_work counts it (the input
// rows the output depends on read once: q at query slots in a valid pair,
// k, v and rbf at key slots in a valid pair, z at valid pairs, e of atoms
// with one, all ids, W and bias; the whole output written once; per valid
// pair 2L+5 FP32 operations per channel, one exp per head and the
// Legendre recurrence; 2*L*K per channel for G of each key in a valid
// pair), flagship X2GNN (H=16, C=8, L=7, K=6) on chip_smoke.py's batches:
// 25,973,992 B, 0.0078 ms at 3.35 TB/s, at the serving shape (N=1024,
// DI=DK=24); 25,326,888 B, 0.0076 ms at the AID serving shape (N=512,
// D=48), where the operations take 0.0075 ms at 67 TFLOP/s;
// 24,302,880 B, 0.0073 ms at the training shape (N=760, D=32). About 30%
// of the padded q, k, v and rbf rows are live and about a sixth of the
// window pairs valid, so the function is bound by bytes, about half of
// them the output.
//
// What held the first design (one CTA of HC threads per atom; 0.6086 ms
// at N=1024, D=24 and 2.0566 ms at N=512, D=48 on an H100 80GB HBM3 at
// 700 W) far from that bound was latency, not bytes:
// - occupancy: it staged k, v, q, an accumulator and G for the whole atom
//   in shared memory (90.5 KB at D=24, 152 KB at D=48), so 8 warps per SM
//   at D=24 and D=32 and 4 at D=48; its shared memory grew with HC, so
//   HC=1024 at L=7 (229,376 B for G alone) and HC=512 from D=13 on were
//   refused at launch though the wrapper accepted them;
// - redundant serial work: every channel thread walked all DI x DK window
//   pairs twice, with a head-sum butterfly and two exps (online softmax)
//   in the first pass and the butterfly, an exp and the L FMAs of s in the
//   second: each (pair, head) score twice and its exp three times, by all
//   C lanes of the head, each step waiting on the one before;
// - pad atoms and invalid pairs were skipped only inside the loops, after
//   every row of the atom had been staged;
// - W was read through L1 for every key of every atom (42 x 128 floats);
// - the Legendre recurrence divided by l for every pair.
//
// What this design does about each:
// - Launch plan and occupancy: a CTA is up to 4 warpgroups, each one
//   thread per channel of a group of up to 128 channels (heads never
//   straddle a group; a wider HC is more CTAs along grid.y), so shared
//   memory no longer grows with HC. It is sized by the Python plan
//   (ops/blocked_attn.py, fwd_plan; `_check` asks it) for a chunk of the
//   atom's valid queries, chunked as _fwd_kernel_ichunk chunks them, so
//   the CTA keeps its 4 warpgroups at D=48 and D=64: 16 warps per SM at
//   D=24, 32 and 48, registers capped at 128 by __launch_bounds__.
// - Persistent CTAs: R = min(N, 132 x ctas_per_sm) CTAs (a function of the
//   shape only) walk the atoms n = r, r + R, ...; each stages its channel
//   group's W (L*K x group) in shared memory once.
// - Only valid slots are walked: warp 0 compacts the atom's valid query
//   and key slots with ballots (the ids loaded one atom ahead) and finds
//   whether any pair is valid (not every valid slot naming one atom); an
//   atom without one (pad atom, degree 0 or 1) writes its zero rows and
//   moves on (a CTA-uniform branch). Every slot of `out` is written, dead
//   ones with 0.
// - One round trip to stage an atom: the valid keys' rbf and k rows and
//   the chunk's q rows go to shared memory by cp.async (no registers, all
//   in flight at once), the first v rows and z go to registers meanwhile,
//   then one wait; each thread adds e to the k rows it copied.
// - Each quantity once per atom and query chunk: pref_l P_l(z) once per
//   valid pair (threads over pairs, reciprocal constants kInv instead of
//   divisions, in shared memory, read back with 16-byte loads); scores
//   and softmax by one thread per (query, head): the C-deep dot product of
//   the query's head slice with each key's (k + e) slice from shared
//   memory (no redundant head-sum butterflies), then the max and the
//   exps and their sum over the compacted keys, each exp once, stored in
//   place of the score (the -5e29 floor of the max and the 1e-16 clamp of
//   the denominator as in _attention_core :141-145); G_k once per key,
//   in registers, from W and the atom's rbf rows in shared memory; the
//   division deferred to one multiply per output element. The scores are
//   one template instance per head width C, which keeps the query's C
//   values in registers: one instance with a runtime C loop, reading them
//   from shared memory, was 6-10% slower at C=8 (0.1038-0.1046 against
//   0.0964-0.0966 ms at N=1024, D=24; 0.2451-0.2456 against
//   0.2240-0.2243 ms at N=512, D=48) and built no faster (8.80 s against
//   8.45 s for both sources), timed in turns by chip_smoke.py on one card.
// - Work split: in the output pass the warpgroups split each atom's keys
//   (key jj goes to warpgroup jj mod WG) and walk them in tiles of
//   kKeyTile: G and vv of a tile in registers (each W value loaded once
//   per tile, each key's K values of an order in 16-byte loads), the
//   output partial read and written once per query and tile, the next
//   tile's v rows loaded early. Splitting the queries instead would need
//   G for every key of the atom in shared memory (nK x L x 128 floats: 86
//   KB at D=24, 229 KB at D=64), which costs the occupancy this design is
//   for. The price is a per-warpgroup output partial per query of the
//   chunk in shared memory, added in warpgroup order: no float atomics, so
//   two runs give bitwise-equal `out`.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.0966
// ms per launch at N=1024, D=24 (12.5x its bound), 0.2243 ms at N=512,
// D=48 (29.7x), 0.0898 ms at N=760, D=32 (12.4x); 16 resident warps per
// SM, 128 registers.
//
// What holds it back now (clock64 phase counts of a development build on
// the card): the output pass reads, per warp, 8 words of pref_l P_l and
// one ex per pair and 42 rbf words per key that every lane needs alike;
// a broadcast still costs one shared-memory wavefront per word (a 16-byte
// load four), and all 4 warps of a warpgroup pay it, so that pass is
// bound by shared-memory wavefronts, not FMAs. And the walk's static split
// of atoms over CTAs leaves the busiest CTA with 1.9x the mean valid pairs
// at N=1024, D=24 and 3.3x at N=512, D=48 (chip_smoke.py prints both).
//
// The mask and the alpha output. Both are applied by the softmax's
// thread per (query, head), once per pair and head: without alpha, it
// stores each valid pair's ex * drop in place of ex as it sums the
// undropped exps; with alpha, a second pass after the sum writes alpha =
// ex * rl for every compacted pair of the chunk, then the dropped ex (the
// output pass reads the dropped weights and is unchanged). The mask is read only at
// valid pairs, at their uncompacted (i, k) slot; alpha's pairs with a pad
// slot, and every pair of an atom without a valid one, get their zeros
// from a pass over the atom's window before the softmax. So the mask adds
// 4 B per valid pair and head to the bound (the float mask, as the
// reference streams it) and alpha its whole (N, DI, DK, H) float32 store,
// paid only when asked; the operations grow by one multiply per valid pair
// and head for each. Measured beside the instance without them by
// chip_smoke.py (phase 9a; PERF.md section 6).
//
// bf16 storage. With q, k, v and e in bfloat16 (ModelConfig.compute_dtype
// "bfloat16"), every value is widened to float32 where it is loaded and
// all math stays float32, as the reference's kernel widens at load
// (:179-182); rbf, W, bias, z, the mask, `out` and alpha stay float32.
// cp.async copies only 4, 8 or 16 bytes, so the bf16 instances stage the
// k and q rows by a plain 2-byte load, a widening and a float32 store to
// the same shared-memory slot (`stage`): the layout, and with it fwd_plan,
// is the float32 instances'. The v rows and e are widened in registers.
// After the load a bf16 instance does the float32 instance's arithmetic
// on the same values, so on bf16 inputs it equals the float32 instance on
// their float32 upcast bit for bit (chip_smoke.py phase 10a checks it).
// The function's live input bytes shrink by 2 B per q, k, v and e element.
// Measured by chip_smoke.py on "NVIDIA H100 80GB HBM3, 700.00 W": the bf16
// instance without mask or alpha takes 0.2263 ms over the 8 tiers of the
// packed training batch against 0.2108 for the float32 one (+5.6% to
// +9.7% per tier), 0.0816 against 0.0786 ms at the AID tier: the plain
// loads of the staging are slower than cp.async, the halved bytes buy
// nothing at 12-100x the byte bound; 128 registers, 16 warps per SM.
//
// Not in this design: tensor cores (each head's q.k is 8 deep and G is a
// 42-deep product; float32 parity would need 3xTF32 for a latency-bound
// kernel) and handing the softmax statistics to the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kMaxL = 8;        // Legendre orders a thread keeps
constexpr int kRegK = 6;        // radial functions per order unrolled in G
constexpr int kMaxDegree = 64;  // DI, DK: two 32-slot ballots
constexpr int kGroupThreads = 128;   // one thread per channel of a group
constexpr int kMaxWarpgroups = 4;    // warpgroups of a CTA split the keys
constexpr int kKeyTile = 4;     // keys of a warpgroup per output-pass step
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one CTA
constexpr float kNeg = -1e30f;
constexpr double kPi = 3.14159265358979323846;

// 4-byte copy from device to shared memory that bypasses the registers:
// every copy of a stage is in flight at once, then one wait
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a stored value as float32: bf16 storage is widened where it is loaded
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one element of a row to shared memory as float32: cp.async for float
// storage (no registers, completed by cp_async_wait_all), a load, a
// widening and a store for bf16 (cp.async copies 4, 8 or 16 bytes)
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src) {
  if constexpr (std::is_same_v<T, float>) {
    cp_async4(dst, src);
  } else {
    *dst = widen(*src);
  }
}

__constant__ float kInv[kMaxL] = {0.f, 1.f, 1.f / 2, 1.f / 3,
                                  1.f / 4, 1.f / 5, 1.f / 6, 1.f / 7};

// channels of a warpgroup: the largest of 128, 96, 64, 32 that divides HC
__host__ __device__ inline int group_threads(int HC) {
  for (int t = kGroupThreads; t > 32; t -= 32) {
    if (HC % t == 0) return t;
  }
  return 32;
}

struct Layout {
  size_t qidx, qa, kidx, kb, pref, cnt, w, rbf, kk, q, acc, ex, p, rl, bytes;
};

__host__ __device__ inline size_t up4(size_t words) {
  return (words + 3) & ~static_cast<size_t>(3);   // 16-byte aligned regions
}

// Shared memory of one CTA of WG warpgroups of TB threads, in 4-byte
// words; ops/blocked_attn.py's fwd_plan computes the same count.
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
  // nI, nK, query mask (2 words), any valid pair, key mask (2 words)
  s.cnt = off;   off += 8;
  s.w = off;     off += LK * TB;     // the group's W columns, per CTA
  // the atom's valid keys' rbf rows, each order's K values padded to Kp
  s.rbf = off;   off += static_cast<size_t>(DK) * L * up4(K);
  s.kk = off;    off += static_cast<size_t>(DK) * TB;   // their k + e rows
  s.q = off;     off += static_cast<size_t>(IC) * TB;   // chunk's q rows
  s.acc = off;   off += static_cast<size_t>(WG) * IC * TB;   // per wg
  s.ex = off;    off += up4(IC * DK * Hb);   // score, then ex (i,key,h)
  s.p = off;     off += static_cast<size_t>(IC) * DK * kMaxL;  // pref_l P_l
  s.rl = off;    off += up4(IC * Hb);  // 1 / denominator (i,h)
  s.bytes = off * 4;
  return s;
}

// Scores and softmax of a query chunk, one thread per (query, head): the
// C-deep dot product of the query's head slice (from shared memory, into
// registers) with each valid key's k + e slice, in channel order, then the
// max over the keys (floored at kNeg / 2) and the exps and their sum, each
// exp once, stored in place of the score; rl = 1 / max(sum, 1e-16).
// ALPHA writes alpha = ex * rl of every compacted pair (the reference's
// pre-dropout alpha output, :194-195); DROP then multiplies each valid
// pair's ex by its mask value, after the sum (the denominator stays
// undropped, :146), so the output pass reads the dropped weights. Both
// read and write at the pair's uncompacted (i, k) slot.
template <int CC, bool DROP, bool ALPHA>
__device__ __forceinline__ void scores_softmax(
    const float* q_s, const float* kk_s, const int* qidx, const int* qa,
    const int* kidx, const int* kb, float* ex_s, float* rl_s, int i0,
    int icnt, int nK, int DK, int TB, float rsc,
    const float* __restrict__ drop, float* __restrict__ alpha, size_t row0,
    int H, int hg0) {
  const int Hb = TB / CC;
  for (int t = threadIdx.x; t < icnt * Hb; t += blockDim.x) {
    const int ii = t / Hb;
    const int h = t - ii * Hb;
    float qv[CC];
    const float* qr = q_s + ii * TB + h * CC;
#pragma unroll
    for (int c = 0; c < CC; ++c) qv[c] = qr[c];
    const int ai = qa[i0 + ii];
    float* row = ex_s + ii * DK * Hb + h;
    float m = kNeg / 2;
#pragma unroll 4
    for (int jj = 0; jj < nK; ++jj) {
      const float* kr = kk_s + jj * TB + h * CC;
      float d = 0.f;
      if constexpr (CC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CC; c += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
          d = fmaf(qv[c], k4.x, d);
          d = fmaf(qv[c + 1], k4.y, d);
          d = fmaf(qv[c + 2], k4.z, d);
          d = fmaf(qv[c + 3], k4.w, d);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CC; ++c) d = fmaf(qv[c], kr[c], d);
      }
      const float sc = kb[jj] == ai ? kNeg : d * rsc;
      row[jj * Hb] = sc;
      m = fmaxf(m, sc);
    }
    // the pair (n, i, k, h) at ((row0 + i) * DK + k) * H + hg0 + h
    const size_t prow = (row0 + qidx[i0 + ii]) * DK;
    const size_t hcol = hg0 + h;
    float l = 0.f;
    if constexpr (DROP && !ALPHA) {   // the sum stays undropped
#pragma unroll 4
      for (int jj = 0; jj < nK; ++jj) {
        const float ex = expf(row[jj * Hb] - m);   // 0 at invalid pairs
        l += ex;
        row[jj * Hb] = kb[jj] != ai
            ? ex * drop[(prow + kidx[jj]) * H + hcol] : ex;
      }
    } else {
      for (int jj = 0; jj < nK; ++jj) {
        const float ex = expf(row[jj * Hb] - m);   // 0 at invalid pairs
        row[jj * Hb] = ex;
        l += ex;
      }
    }
    const float rl = 1.f / fmaxf(l, 1e-16f);
    rl_s[ii * Hb + h] = rl;
    if constexpr (ALPHA) {   // alpha needs the sum first, then the mask
#pragma unroll 4
      for (int jj = 0; jj < nK; ++jj) {
        const size_t at = (prow + kidx[jj]) * H + hcol;
        const float ex = row[jj * Hb];
        alpha[at] = ex * rl;
        if constexpr (DROP) {
          if (kb[jj] != ai) row[jj * Hb] = ex * drop[at];
        }
      }
    }
  }
}

// T is the storage type of q, k, v and e (float or __nv_bfloat16); DROP
// and ALPHA are the reference's HAS_DROP and WANT_ALPHA (:166-195):
// without them the float instance is the kernel measured above, its
// registers and its occupancy unchanged.
template <typename T, bool DROP, bool ALPHA>
__global__ void __launch_bounds__(kGroupThreads * kMaxWarpgroups, 1)
blocked_attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ e,
    const float* __restrict__ rbf, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ z,
    const int* __restrict__ a_ids, const int* __restrict__ b_ids,
    const float* __restrict__ drop, float* __restrict__ out,
    float* __restrict__ alpha, int N, int DI, int DK, int HC, int TB, int C,
    int L, int K, int IC, float rsc) {
  extern __shared__ __align__(16) float smem[];
  const int NT = blockDim.x;                // WG warpgroups of TB threads
  const int WG = NT / TB;
  const Layout lay = make_layout(DI, DK, TB, WG, C, L, K, IC);
  int* qidx = reinterpret_cast<int*>(smem + lay.qidx);
  int* qa = reinterpret_cast<int*>(smem + lay.qa);
  int* kidx = reinterpret_cast<int*>(smem + lay.kidx);
  int* kb = reinterpret_cast<int*>(smem + lay.kb);
  float* pref_s = smem + lay.pref;
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + lay.cnt);
  float* w_s = smem + lay.w;
  float* rbf_s = smem + lay.rbf;
  float* kk_s = smem + lay.kk;
  float* q_s = smem + lay.q;
  float* ex_s = smem + lay.ex;
  float* p_s = smem + lay.p;
  float* rl_s = smem + lay.rl;

  const int tid = threadIdx.x;
  const int wg = tid / TB;                  // this thread's warpgroup
  const int lt = tid - wg * TB;
  const int hc = blockIdx.y * TB + lt;      // its channel
  const int Hb = TB / C;
  const int hb = lt / C;                    // its head within the group
  const int lane = tid & 31;
  const int LK = L * K;
  const int Kp = static_cast<int>(up4(K));
  const int LKp = L * Kp;
  float* acc_w = smem + lay.acc + static_cast<size_t>(wg) * IC * TB;
  const float bv = bias[hc];
  if (tid < L) {
    // same float32 value as the reference's f64 numpy prefactor
    pref_s[tid] = static_cast<float>(sqrt((2.0 * tid + 1.0) / (4.0 * kPi)));
  }
  for (int t = tid; t < LK * TB; t += NT) {   // W: read once per CTA
    const int r = t / TB;
    w_s[t] = w[static_cast<size_t>(r) * HC + blockIdx.y * TB + (t - r * TB)];
  }
  // warp 0 holds the ids of the CTA's next atom, loaded one atom early
  int ids[4] = {-1, -1, -1, -1};
  auto load_ids = [&](int n) {
    if (tid < 32 && n < N) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = u * 32 + lane;
        ids[u] = i < DI ? a_ids[static_cast<size_t>(n) * DI + i] : -1;
        ids[2 + u] = i < DK ? b_ids[static_cast<size_t>(n) * DK + i] : -1;
      }
    }
  };
  load_ids(blockIdx.x);

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    __syncthreads();   // the previous atom is done with shared memory
    // ---- compact the valid query and key slots (warp 0, ballots); an
    // atom has a valid pair unless all its valid slots name one atom ----
    if (tid < 32) {
      int cntI = 0, cntK = 0;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int a = ids[u], b = ids[2 + u];
        const unsigned mi = __ballot_sync(0xffffffffu, a >= 0);
        if (a >= 0) {
          const int slot = cntI + __popc(mi & ((1u << lane) - 1u));
          qidx[slot] = u * 32 + lane;
          qa[slot] = a;
        }
        cntI += __popc(mi);
        const unsigned mk = __ballot_sync(0xffffffffu, b >= 0);
        if (b >= 0) {
          const int slot = cntK + __popc(mk & ((1u << lane) - 1u));
          kidx[slot] = u * 32 + lane;
          kb[slot] = b;
        }
        cntK += __popc(mk);
        if (lane == 0) {
          cnt[2 + u] = mi;
          cnt[5 + u] = mk;
        }
      }
      load_ids(n + gridDim.x);
      __syncwarp();
      bool differ = false;
      if (cntI > 0 && cntK > 0) {
        const int x = qa[0];
        for (int t = lane; t < cntI; t += 32) differ |= qa[t] != x;
        for (int t = lane; t < cntK; t += 32) differ |= kb[t] != x;
      }
      const unsigned any = __any_sync(0xffffffffu, differ);
      if (lane == 0) {
        cnt[0] = cntI;
        cnt[1] = cntK;
        cnt[4] = any;
      }
    }
    __syncthreads();
    const int nI = cnt[0], nK = cnt[1];
    const bool any = cnt[4] != 0;

    // ---- zeros at pad query slots (every slot if no pair is valid) ----
    for (int i = wg; i < DI; i += WG) {
      if (!any || !((cnt[2 + (i >> 5)] >> (i & 31)) & 1u)) {
        out[(static_cast<size_t>(n) * DI + i) * HC + hc] = 0.f;
      }
    }
    if constexpr (ALPHA) {
      // alpha 0 at every pair of the group's heads with a pad slot (every
      // pair if none is valid); the softmax writes the others
      const int Hg = HC / C;
      const int per_i = DK * Hb;
      for (int t = tid; t < DI * per_i; t += NT) {
        const int i = t / per_i;
        const int kk = (t - i * per_i) / Hb;
        const int h = t - i * per_i - kk * Hb;
        if (!any || !((cnt[2 + (i >> 5)] >> (i & 31)) & 1u) ||
            !((cnt[5 + (kk >> 5)] >> (kk & 31)) & 1u)) {
          alpha[((static_cast<size_t>(n) * DI + i) * DK + kk) * Hg +
                blockIdx.y * Hb + h] = 0.f;
        }
      }
    }
    if (!any) continue;   // uniform over the CTA

    // ---- stage the atom and its first query chunk in one round trip:
    // asynchronous copies of the valid keys' rbf and k rows and the
    // chunk's q rows, the first v rows and z into registers, one wait ----
    for (int t = tid; t < nK * LK; t += NT) {
      const int jj = t / LK;
      const int r = t - jj * LK;
      const int l = r / K;
      cp_async4(rbf_s + jj * LKp + l * Kp + (r - l * K),
                rbf + (static_cast<size_t>(n) * DK + kidx[jj]) * LK + r);
    }
    for (int jj = wg; jj < nK; jj += WG) {
      stage(kk_s + jj * TB + lt,
            k + (static_cast<size_t>(n) * DK + kidx[jj]) * HC + hc);
    }
    const float ev = widen(e[static_cast<size_t>(n) * HC + hc]);
    // this warpgroup's keys are wg, wg + WG, ...: nKw of them
    const int nKw = nK > wg ? (nK - wg + WG - 1) / WG : 0;
    for (int i0 = 0; i0 < nI; i0 += IC) {
      const int icnt = min(IC, nI - i0);
      // ---- the chunk's q rows; this warpgroup's output partial at 0 ----
      for (int ii = wg; ii < icnt; ii += WG) {
        stage(q_s + ii * TB + lt,
              q + (static_cast<size_t>(n) * DI + qidx[i0 + ii]) * HC + hc);
      }
      for (int ii = 0; ii < icnt; ++ii) acc_w[ii * TB + lt] = 0.f;
      // the v rows of this warpgroup's first key tile, loaded early
      float vn[kKeyTile];
#pragma unroll
      for (int u = 0; u < kKeyTile; ++u) {
        vn[u] = u < nKw ? widen(v[(static_cast<size_t>(n) * DK
                                   + kidx[wg + u * WG]) * HC + hc]) : 0.f;
      }
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
      cp_async_wait_all();
      if (i0 == 0) {   // kk = k + e, on the rows this thread copied
        for (int jj = wg; jj < nK; jj += WG) kk_s[jj * TB + lt] += ev;
      }
      __syncthreads();   // rows staged by other warpgroups
      // ---- scores and softmax, one thread per (query, head) ----
#define SCORES(CC)                                                      \
  scores_softmax<CC, DROP, ALPHA>(q_s, kk_s, qidx, qa, kidx, kb, ex_s,  \
                                  rl_s, i0, icnt, nK, DK, TB, rsc, drop, \
                                  alpha, static_cast<size_t>(n) * DI,    \
                                  HC / C, blockIdx.y * Hb)
      switch (C) {
        case 1: SCORES(1); break;
        case 2: SCORES(2); break;
        case 4: SCORES(4); break;
        case 8: SCORES(8); break;
        case 16: SCORES(16); break;
        default: SCORES(32); break;
      }
#undef SCORES
      __syncthreads();
      // ---- output pass: the warpgroup's keys in tiles of kKeyTile, G and
      // vv of the tile in registers (each W value loaded once per tile),
      // the output partial read and written once per query and tile; an
      // invalid pair has ex exactly 0 and adds 0 ----
      for (int u0 = 0; u0 < nKw; u0 += kKeyTile) {
        float vj[kKeyTile];
#pragma unroll
        for (int u = 0; u < kKeyTile; ++u) vj[u] = vn[u] + ev;
#pragma unroll
        for (int u = 0; u < kKeyTile; ++u) {   // the next tile's v rows
          const int uu = u0 + kKeyTile + u;
          vn[u] = uu < nKw ? widen(v[(static_cast<size_t>(n) * DK
                                      + kidx[wg + uu * WG]) * HC + hc])
                           : 0.f;
        }
        // G[u][l] = sum_t rbf[key u, l*K+t] W[l*K+t, channel], t in order:
        // each W value loaded once for the tile's keys, each key's K values
        // of an order in 16-byte loads (a tile past the warpgroup's last
        // key repeats that key)
        const float* rb[kKeyTile];
#pragma unroll
        for (int u = 0; u < kKeyTile; ++u) {
          rb[u] = rbf_s + (wg + min(u0 + u, nKw - 1) * WG) * LKp;
        }
        float G[kKeyTile][kMaxL];
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
#pragma unroll
          for (int u = 0; u < kKeyTile; ++u) G[u][l] = 0.f;
          if (l < L && K <= kRegK) {
            float wv[kRegK];
#pragma unroll
            for (int t = 0; t < kRegK; ++t) {
              wv[t] = t < K ? w_s[(l * K + t) * TB + lt] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kKeyTile; ++u) {
              const float4* r4 =
                  reinterpret_cast<const float4*>(rb[u] + l * Kp);
              const float4 r0 = r4[0];
              const float4 r1 = K > 4 ? r4[1] : make_float4(0.f, 0.f, 0.f,
                                                            0.f);
              const float r[8] = {r0.x, r0.y, r0.z, r0.w,
                                  r1.x, r1.y, r1.z, r1.w};
#pragma unroll
              for (int t = 0; t < kRegK; ++t) {
                if (t < K) G[u][l] = fmaf(r[t], wv[t], G[u][l]);
              }
            }
          } else if (l < L) {
            for (int t = 0; t < K; ++t) {
              const float wv = w_s[(l * K + t) * TB + lt];
#pragma unroll
              for (int u = 0; u < kKeyTile; ++u) {
                G[u][l] = fmaf(rb[u][l * Kp + t], wv, G[u][l]);
              }
            }
          }
        }
        for (int ii = 0; ii < icnt; ++ii) {
          float a = acc_w[ii * TB + lt];
#pragma unroll
          for (int u = 0; u < kKeyTile; ++u) {
            if (u0 + u < nKw) {
              const int jj = wg + (u0 + u) * WG;
              const float ex = ex_s[(ii * DK + jj) * Hb + hb];
              // pref_l P_l of the pair, two 16-byte loads
              const float4* pp = reinterpret_cast<const float4*>(
                  p_s + (ii * DK + jj) * kMaxL);
              const float4 p0 = pp[0], p1 = pp[1];
              const float P[kMaxL] = {p0.x, p0.y, p0.z, p0.w,
                                      p1.x, p1.y, p1.z, p1.w};
              float s = bv;
#pragma unroll
              for (int l = 0; l < kMaxL; ++l) {
                if (l < L) s = fmaf(P[l], G[u][l], s);
              }
              a = fmaf(vj[u] * s, ex, a);   // ex carries the mask
            }
          }
          acc_w[ii * TB + lt] = a;
        }
      }
      __syncthreads();
      // ---- out rows: the warpgroups' partials added in warpgroup order,
      // then the deferred division, one multiply per element ----
      const float* acc_all = smem + lay.acc;
      for (int ii = wg; ii < icnt; ii += WG) {
        float a = acc_all[ii * TB + lt];
        for (int u = 1; u < WG; ++u) {
          a += acc_all[(static_cast<size_t>(u) * IC + ii) * TB + lt];
        }
        out[(static_cast<size_t>(n) * DI + qidx[i0 + ii]) * HC + hc] =
            a * rl_s[ii * Hb + hb];
      }
      __syncthreads();   // before the next chunk overwrites the chunk area
    }
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

// an instance as the runtime API takes it (launched by cudaLaunchKernel,
// whose argument array does not depend on the storage type)
template <typename T, bool DROP, bool ALPHA>
const void* instance() {
  return reinterpret_cast<const void*>(
      blocked_attn_fwd_kernel<T, DROP, ALPHA>);
}

// the instance of variant 0..7: (drop, alpha) = (0,0), (1,0), (0,1), (1,1)
// in float storage, then the same four in bf16 storage (ops/blocked_attn.py
// FWD_VARIANTS); nullptr for another value
const void* fwd_instance(int variant) {
  using bf16 = __nv_bfloat16;
  switch (variant) {
    case 0: return instance<float, false, false>();
    case 1: return instance<float, true, false>();
    case 2: return instance<float, false, true>();
    case 3: return instance<float, true, true>();
    case 4: return instance<bf16, false, false>();
    case 5: return instance<bf16, true, false>();
    case 6: return instance<bf16, false, true>();
    case 7: return instance<bf16, true, true>();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape, launch plan or storage type the
// kernel does not take. All pointers are device pointers to contiguous
// arrays: q (N,DI,HC), k/v (N,DK,HC), e (N,HC), all four float32
// (storage 0) or bfloat16 (storage 1), rbf (N,DK,L*K), w (L*K,HC),
// bias (HC), z (N,DI,DK), a_ids (N,DI) int32, b_ids (N,DK) int32,
// out (N,DI,HC); drop (N,DI,DK,H), the keep mask pre-scaled by 1/keep,
// and alpha (N,DI,DK,H), the pre-dropout weights written whole, are
// nullable: a null one leaves its branch out (its own instance). The plan
// (grid, threads, warpgroups, i_chunk, smem_bytes) is
// ops/blocked_attn.py's fwd_plan for the shape.
int blocked_attn_fwd(const void* q, const void* k, const void* v,
                     const void* e, const float* rbf, const float* w,
                     const float* bias, const float* z, const int* a_ids,
                     const int* b_ids, const float* drop, float* out,
                     float* alpha, int storage, int N, int DI, int DK, int H,
                     int C, int L, int K, int grid, int threads,
                     int warpgroups, int i_chunk, int smem_bytes,
                     void* stream) {
  int HC = H * C;
  if (!plan_ok(N, DI, DK, HC, C, L, K, grid, threads, warpgroups, i_chunk,
               smem_bytes) || (storage != 0 && storage != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kern = fwd_instance(
      (drop != nullptr) + 2 * (alpha != nullptr) + 4 * storage);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float rsc = static_cast<float>(1.0 / sqrt(static_cast<double>(C)));
  void* args[] = {&q, &k, &v, &e, &rbf, &w, &bias, &z, &a_ids, &b_ids,
                  &drop, &out, &alpha, &N, &DI, &DK,
                  &HC, &threads, &C, &L, &K, &i_chunk,
                  &rsc};
  err = cudaLaunchKernel(kern, dim3(grid, HC / threads),
                         dim3(threads * warpgroups), args, smem_bytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// info[0..3] = registers per thread, local (spill) bytes per thread, static
// shared bytes, and resident CTAs per SM of the forward kernel's instance
// `variant` (0..7, as fwd_instance) at `threads` threads and `smem_bytes`
// of dynamic shared memory.
int blocked_attn_fwd_occupancy(int threads, int smem_bytes, int variant,
                               int* info) {
  const void* kern = fwd_instance(variant);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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

const char* blocked_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
