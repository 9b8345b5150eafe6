// Fused atom-blocked attention forward for Hopper (sm_90a), float32.
//
// Replaces the two Pallas forward kernels of
// x2gnn_tpu/ops/pallas/blocked_attn.py: `_fwd_kernel` (:166, math in
// `_attention_core` :107) and `_fwd_kernel_ichunk` (:282), which computes
// the same function with the query axis tiled for the TPU's 16 MB VMEM.
// One kernel covers both: any DI, DK <= 64 and HC = H*C with C dividing 32.
//
// For one atom n (out-edges k of the atom, in-edges i):
//   kk = k + e, vv = v + e                                  (per channel)
//   valid(i,k) = a_id[i] != b_id[k] && a_id[i] >= 0 && b_id[k] >= 0
//   score(i,k,h) = sum_{c in head h} q[i,c] kk[k,c] / sqrt(C)
//   m(i,h) = max(max_k valid score, -5e29); ex = exp(score - m), 0 if invalid
//   G[k,l,:] = sum_n rbf[k, l*K+n] W[l*K+n, :]               (W un-expanded)
//   s(i,k,:) = bias + sum_l pref_l P_l(z[i,k]) G[k,l,:]
//   out[i,:] = sum_k vv[k,:] s(i,k,:) ex(i,k,h) / max(sum_k ex(i,k,h), 1e-16)
// Fully masked rows (pad atoms, pad slots, degree-0/1 atoms) give exactly 0.
//
// Two devices of the TPU kernel exist only for its 128x128 matrix unit and
// are dropped: the head-indicator matmuls (the per-head sum over C
// channels is a shuffle-reduce inside C-lane groups of a warp) and the
// block-diagonal W_bd, which is 7/8 zeros (G is a K-deep FMA chain over
// the un-expanded (L*K, HC) weight).
//
// Bound at the serving shape (flagship X2GNN, 32 QM9-scale molecules:
// N=1024, DI=DK=24, H=16, C=8, L=7, K=6), counted as the port's
// chip_smoke.py counts it: each input read once and the output written
// once is ~57 MB (q, k, v and out are 12.6 MB each), 17 us at 3.35 TB/s.
// The operations these inputs need scale with the valid pairs only
// (about a sixth of the 590k window pairs; per valid pair and channel
// 2L+5 FP32 operations, plus G for each real key): a few hundred MFLOP,
// a few us at 67 TFLOP/s. So the function is bound by bytes.
//
// What this first design does about it: one CTA per atom and one thread
// per channel, so every load of q/k/v/out is one coalesced row; k, v, q
// are staged in shared memory once and read from there in both passes,
// so device memory sees each input about once. Invalid pairs are skipped
// (validity depends on (i, k) only, so the branch is uniform over the
// CTA). Pass 1 computes the per-(i, head) max and denominator by an online
// softmax; pass 2 walks the keys in tiles of kKeyTile, stages G and the
// Legendre values of the tile in shared memory and accumulates the
// unnormalized output per thread. Making it fast (several atoms per CTA,
// wgmma for the q.k and G products, TMA) is later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kKeyTile = 8;
constexpr float kNeg = -1e30f;
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float head_sum(float x, int C) {
  // C-lane groups are aligned inside a warp (C divides 32); xor butterfly
  // leaves every lane of the group with the same (commutative) sum
  for (int off = C >> 1; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Layout {
  size_t kk, vv, q, acc, g, p, m, rl, rbf, pref, a, b, bytes;
};

__host__ __device__ inline Layout make_layout(int DI, int DK, int H, int C,
                                              int L, int K) {
  const size_t HC = static_cast<size_t>(H) * C;
  Layout s{};
  size_t off = 0;  // in 4-byte words
  s.kk = off;   off += DK * HC;
  s.vv = off;   off += DK * HC;
  s.q = off;    off += DI * HC;
  s.acc = off;  off += DI * HC;
  s.g = off;    off += static_cast<size_t>(kKeyTile) * L * HC;
  s.p = off;    off += static_cast<size_t>(DI) * kKeyTile * L;
  s.m = off;    off += static_cast<size_t>(DI) * H;
  s.rl = off;   off += static_cast<size_t>(DI) * H;
  s.rbf = off;  off += static_cast<size_t>(DK) * L * K;
  s.pref = off; off += L;
  s.a = off;    off += DI;
  s.b = off;    off += DK;
  s.bytes = off * 4;
  return s;
}

__global__ void blocked_attn_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ e,
    const float* __restrict__ rbf, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ z,
    const int* __restrict__ a_ids, const int* __restrict__ b_ids,
    float* __restrict__ out, int DI, int DK, int H, int C, int L, int K,
    float sqrt_c) {
  extern __shared__ float smem[];
  const Layout lay = make_layout(DI, DK, H, C, L, K);
  float* kk_s = smem + lay.kk;
  float* vv_s = smem + lay.vv;
  float* q_s = smem + lay.q;
  float* acc_s = smem + lay.acc;
  float* g_s = smem + lay.g;
  float* p_s = smem + lay.p;
  float* m_s = smem + lay.m;
  float* rl_s = smem + lay.rl;
  float* rbf_s = smem + lay.rbf;
  float* pref_s = smem + lay.pref;
  int* a_s = reinterpret_cast<int*>(smem + lay.a);
  int* b_s = reinterpret_cast<int*>(smem + lay.b);

  const int HC = blockDim.x;
  const int hc = threadIdx.x;
  const int h = hc / C;
  const int c = hc - h * C;
  const int LK = L * K;
  const size_t n = blockIdx.x;

  // ---- stage the atom's rows; thread hc owns column hc of k/v/q/acc ----
  const float ev = e[n * HC + hc];
  const float bv = bias[hc];
  for (int r = 0; r < DK; ++r) {
    const size_t off = (n * DK + r) * HC + hc;
    kk_s[r * HC + hc] = k[off] + ev;
    vv_s[r * HC + hc] = v[off] + ev;
  }
  for (int r = 0; r < DI; ++r) {
    q_s[r * HC + hc] = q[(n * DI + r) * HC + hc];
    acc_s[r * HC + hc] = 0.f;
  }
  for (int t = hc; t < DK * LK; t += HC) rbf_s[t] = rbf[n * DK * LK + t];
  for (int t = hc; t < DI; t += HC) a_s[t] = a_ids[n * DI + t];
  for (int t = hc; t < DK; t += HC) b_s[t] = b_ids[n * DK + t];
  for (int t = hc; t < L; t += HC) {
    // same float32 value as the reference's f64 numpy prefactor
    pref_s[t] = static_cast<float>(sqrt((2.0 * t + 1.0) / (4.0 * kPi)));
  }
  __syncthreads();

  // ---- pass 1: per-(query, head) max and softmax denominator ----
  for (int i = 0; i < DI; ++i) {
    const int ai = a_s[i];
    float m = kNeg / 2, l = 0.f;
    if (ai >= 0) {
      const float qi = q_s[i * HC + hc];
      for (int j = 0; j < DK; ++j) {
        const int bj = b_s[j];
        if (bj < 0 || bj == ai) continue;  // uniform over the CTA
        const float sc = head_sum(qi * kk_s[j * HC + hc], C) / sqrt_c;
        const float mn = fmaxf(m, sc);
        l = l * expf(m - mn) + expf(sc - mn);
        m = mn;
      }
    }
    if (c == 0) {
      m_s[i * H + h] = m;
      rl_s[i * H + h] = 1.f / fmaxf(l, 1e-16f);
    }
  }

  // ---- pass 2: key tiles; G and Legendre values staged per tile ----
  for (int k0 = 0; k0 < DK; k0 += kKeyTile) {
    const int nt = min(kKeyTile, DK - k0);
    __syncthreads();  // previous tile consumed; pass-1 stats visible
    for (int t = 0; t < nt; ++t) {
      if (b_s[k0 + t] < 0) continue;
      const float* rb = rbf_s + (k0 + t) * LK;
      for (int l = 0; l < L; ++l) {
        float g = 0.f;
        for (int j = 0; j < K; ++j) {
          g = fmaf(rb[l * K + j],
                   __ldg(w + static_cast<size_t>(l * K + j) * HC + hc), g);
        }
        g_s[(t * L + l) * HC + hc] = pref_s[l] * g;
      }
    }
    for (int p = hc; p < DI * nt; p += HC) {
      const int i = p / nt, t = p - (p / nt) * nt;
      const float zz = z[(n * DI + i) * DK + k0 + t];
      float* dst = p_s + (i * kKeyTile + t) * L;
      float p0 = 1.f, p1 = zz;
      dst[0] = p0;
      if (L > 1) dst[1] = p1;
      for (int l = 2; l < L; ++l) {
        const float p2 = ((2 * l - 1) * zz * p1 - (l - 1) * p0) / l;
        dst[l] = p2;
        p0 = p1;
        p1 = p2;
      }
    }
    __syncthreads();
    for (int i = 0; i < DI; ++i) {
      const int ai = a_s[i];
      if (ai < 0) continue;
      const float qi = q_s[i * HC + hc];
      const float mi = m_s[i * H + h];
      float a = acc_s[i * HC + hc];
      for (int t = 0; t < nt; ++t) {
        const int bj = b_s[k0 + t];
        if (bj < 0 || bj == ai) continue;
        const float sc =
            head_sum(qi * kk_s[(k0 + t) * HC + hc], C) / sqrt_c;
        const float ex = expf(sc - mi);
        const float* pp = p_s + (i * kKeyTile + t) * L;
        const float* gg = g_s + t * L * HC + hc;
        float s = bv;
        for (int l = 0; l < L; ++l) s = fmaf(pp[l], gg[l * HC], s);
        a = fmaf(vv_s[(k0 + t) * HC + hc] * s, ex, a);
      }
      acc_s[i * HC + hc] = a;
    }
  }

  // ---- deferred softmax division ----
  for (int i = 0; i < DI; ++i) {
    out[(n * DI + i) * HC + hc] = acc_s[i * HC + hc] * rl_s[i * H + h];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// All pointers are device pointers to contiguous arrays:
// q (N,DI,HC), k/v (N,DK,HC), e (N,HC), rbf (N,DK,L*K), w (L*K,HC),
// bias (HC), z (N,DI,DK), a_ids (N,DI) int32, b_ids (N,DK) int32,
// out (N,DI,HC). The caller checks shapes; N >= 1, DI and DK in 1..64.
int blocked_attn_fwd(const float* q, const float* k, const float* v,
                     const float* e, const float* rbf, const float* w,
                     const float* bias, const float* z, const int* a_ids,
                     const int* b_ids, float* out, int N, int DI, int DK,
                     int H, int C, int L, int K, void* stream) {
  const Layout lay = make_layout(DI, DK, H, C, L, K);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  blocked_attn_fwd_kernel<<<N, H * C, lay.bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, e, rbf, w, bias, z, a_ids, b_ids, out, DI, DK, H, C, L, K,
      static_cast<float>(sqrt(static_cast<double>(C))));
  return static_cast<int>(cudaGetLastError());
}

const char* blocked_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
