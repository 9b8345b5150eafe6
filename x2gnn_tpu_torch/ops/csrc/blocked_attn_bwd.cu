// Fused atom-blocked attention backward for Hopper (sm_90a), float32.
//
// Replaces the two Pallas backward kernels of
// x2gnn_tpu/ops/pallas/blocked_attn.py: `_bwd_kernel` (:198) and
// `_bwd_kernel_ichunk` (:346), which computes the same function with the
// query axis tiled for the TPU's 16 MB VMEM. One kernel covers both: any
// DI, DK <= 64, HC = H*C with C dividing 32, and L <= kMaxL.
//
// Forward (blocked_attn_fwd.cu), per atom n, with kk = k + e, vv = v + e:
//   alpha(i,k,h) = softmax_k over valid pairs of q[i].kk[k] / sqrt(C)
//   s(i,k,:)     = bias + sum_l pref_l P_l(z[i,k]) G[k,l,:]
//   G[k,l,:]     = sum_n rbf[k, l*K+n] W[l*K+n, :]
//   out[i,:]     = sum_k alpha(i,k,h) vv[k,:] s(i,k,:)
// Backward from g = d out (N, DI, HC), recomputing the softmax:
//   ds(i,k,c)     = g vv alpha                (= gn vv ex, gn = g * rnorm)
//   dv[k,c]       = sum_i g s alpha
//   dalpha(i,k,h) = sum_{c in h} g vv s
//   inner(i,h)    = sum_k alpha dalpha = sum_{c in h} g(i,c) out(i,c)
//   dscore        = alpha (dalpha - inner) / sqrt(C), 0 at invalid pairs
//   dq[i] = sum_k dscore kk[k],  dk[k] = sum_i dscore q[i]
//   de    = sum_k (dk + dv)                     (e is added to k and v)
//   dW[l*K+n, c] = sum_{atoms,k} rbf[k, l*K+n] pref_l sum_i P_l ds
//   db[c]        = sum_{atoms,i,k} ds
// dW and db sum over the whole grid. No float atomics: each CTA writes its
// (L*K + 1, HC) partial, and blocked_attn_bwd_reduce sums the partials of
// all atoms in a fixed order, so two runs give bitwise-equal dW and db.
//
// Bound at the shape chip_smoke.py checks (flagship X2GNN, 32 QM9-scale
// molecules, N=1024, DI=DK=24, H=16, C=8, L=7, K=6), counted as it counts
// it: each input (q, k, v, e, rbf, W, bias, z, ids, g) read once and each
// output (dq, dk, dv, de, dW, db) written once is ~96 MB, 29 us at
// 3.35 TB/s. The operations scale with the valid pairs (about a sixth of
// the window pairs) at 4L+17 FP32 operations per pair and channel: ~0.7
// GFLOP, 10 us at 67 TFLOP/s. So the function is bound by bytes.
//
// What this first design does: one CTA per atom and one thread per
// channel, as the forward. Every per-atom row (kk, vv, q, g, dq) is staged
// in shared memory in the thread-per-column layout, so each thread touches
// only its own column and no barrier is needed between the pair loops.
// Three passes:
//   A (query-outer): per-(i, h) max and denominator, an online softmax;
//   B (key-outer):   G_k in registers, the unnormalized forward output
//                    accumulated in shared memory, then
//                    inner(i,h) = rnorm * head_sum(g * acc);
//   C (key-outer):   G_k, dG_k, dk_k, dv_k in registers; dq accumulated in
//                    shared memory (reusing acc), dW's partial in shared
//                    memory (L*K*HC floats).
// The full dG (DK, L*HC) never exists: at DK=48 it alone would be 172 KB.
// The scores are computed three times (once per pass); a faster kernel
// (several atoms per CTA, wgmma for the q.k and G products, TMA) is later
// work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxL = 8;   // registers hold G_k, dG_k and P_l(z) per thread
constexpr float kNeg = -1e30f;
constexpr double kPi = 3.14159265358979323846;
constexpr int kReduceRowLanes = 8;   // reduce: rows interleaved over 8 lanes

__device__ __forceinline__ float head_sum(float x, int C) {
  // C-lane groups are aligned inside a warp (C divides 32); the xor
  // butterfly leaves every lane of a group with the same sum, bit for bit
  for (int off = C >> 1; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Layout {
  size_t kk, vv, q, g, acc, dw, z, rbf, m, rl, inner, pref, a, b, bytes;
};

__host__ __device__ inline Layout make_layout(int DI, int DK, int H, int C,
                                              int L, int K) {
  const size_t HC = static_cast<size_t>(H) * C;
  Layout s{};
  size_t off = 0;  // in 4-byte words
  s.kk = off;    off += DK * HC;
  s.vv = off;    off += DK * HC;
  s.q = off;     off += DI * HC;
  s.g = off;     off += DI * HC;
  s.acc = off;   off += DI * HC;   // forward accumulator, then dq
  s.dw = off;    off += static_cast<size_t>(L) * K * HC;
  s.z = off;     off += static_cast<size_t>(DI) * DK;
  s.rbf = off;   off += static_cast<size_t>(DK) * L * K;
  s.m = off;     off += static_cast<size_t>(DI) * H;
  s.rl = off;    off += static_cast<size_t>(DI) * H;
  s.inner = off; off += static_cast<size_t>(DI) * H;
  s.pref = off;  off += L;
  s.a = off;     off += DI;
  s.b = off;     off += DK;
  s.bytes = off * 4;
  return s;
}

// pref_l P_l(z) for l < L (the forward's Legendre recurrence), 0 beyond
__device__ __forceinline__ void legendre(float zz, const float* pref, int L,
                                         float* p) {
  float p0 = 1.f, p1 = zz;
  p[0] = pref[0];
  p[1] = L > 1 ? pref[1] * p1 : 0.f;
#pragma unroll
  for (int l = 2; l < kMaxL; ++l) {
    p[l] = 0.f;
    if (l < L) {
      const float p2 = ((2 * l - 1) * zz * p1 - (l - 1) * p0) / l;
      p[l] = pref[l] * p2;
      p0 = p1;
      p1 = p2;
    }
  }
}

// G[k, l, hc] for l < L from the atom's staged radial factors
__device__ __forceinline__ void load_g(const float* rb, const float* w,
                                       int L, int K, int HC, int hc,
                                       float* G) {
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) {
    float acc = 0.f;
    if (l < L) {
      for (int j = 0; j < K; ++j) {
        acc = fmaf(rb[l * K + j],
                   __ldg(w + static_cast<size_t>(l * K + j) * HC + hc), acc);
      }
    }
    G[l] = acc;
  }
}

__global__ void blocked_attn_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ e,
    const float* __restrict__ rbf, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ z,
    const int* __restrict__ a_ids, const int* __restrict__ b_ids,
    const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ de,
    float* __restrict__ partial, int DI, int DK, int H, int C, int L, int K,
    float sqrt_c) {
  extern __shared__ float smem[];
  const Layout lay = make_layout(DI, DK, H, C, L, K);
  float* kk_s = smem + lay.kk;
  float* vv_s = smem + lay.vv;
  float* q_s = smem + lay.q;
  float* g_s = smem + lay.g;
  float* acc_s = smem + lay.acc;
  float* dw_s = smem + lay.dw;
  float* z_s = smem + lay.z;
  float* rbf_s = smem + lay.rbf;
  float* m_s = smem + lay.m;
  float* rl_s = smem + lay.rl;
  float* inner_s = smem + lay.inner;
  float* pref_s = smem + lay.pref;
  int* a_s = reinterpret_cast<int*>(smem + lay.a);
  int* b_s = reinterpret_cast<int*>(smem + lay.b);

  const int HC = blockDim.x;
  const int hc = threadIdx.x;
  const int h = hc / C;
  const int c = hc - h * C;
  const int LK = L * K;
  const size_t n = blockIdx.x;

  // ---- stage the atom's rows; thread hc owns column hc ----
  const float ev = e[n * HC + hc];
  const float bv = bias[hc];
  for (int r = 0; r < DK; ++r) {
    const size_t off = (n * DK + r) * HC + hc;
    kk_s[r * HC + hc] = k[off] + ev;
    vv_s[r * HC + hc] = v[off] + ev;
  }
  for (int r = 0; r < DI; ++r) {
    const size_t off = (n * DI + r) * HC + hc;
    q_s[r * HC + hc] = q[off];
    g_s[r * HC + hc] = g[off];
    acc_s[r * HC + hc] = 0.f;
  }
  for (int t = 0; t < LK; ++t) dw_s[t * HC + hc] = 0.f;
  for (int t = hc; t < DI * DK; t += HC) z_s[t] = z[n * DI * DK + t];
  for (int t = hc; t < DK * LK; t += HC) rbf_s[t] = rbf[n * DK * LK + t];
  for (int t = hc; t < DI; t += HC) a_s[t] = a_ids[n * DI + t];
  for (int t = hc; t < DK; t += HC) b_s[t] = b_ids[n * DK + t];
  for (int t = hc; t < L; t += HC) {
    // same float32 value as the reference's f64 numpy prefactor
    pref_s[t] = static_cast<float>(sqrt((2.0 * t + 1.0) / (4.0 * kPi)));
  }
  __syncthreads();

  // ---- pass A: per-(query, head) max and softmax denominator ----
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
  __syncthreads();

  // ---- pass B: unnormalized forward output, then inner(i, h) ----
  float G[kMaxL], P[kMaxL];
  for (int j = 0; j < DK; ++j) {
    const int bj = b_s[j];
    if (bj < 0) continue;
    load_g(rbf_s + j * LK, w, L, K, HC, hc, G);
    const float kj = kk_s[j * HC + hc];
    const float vj = vv_s[j * HC + hc];
    for (int i = 0; i < DI; ++i) {
      const int ai = a_s[i];
      if (ai < 0 || ai == bj) continue;
      const float sc = head_sum(q_s[i * HC + hc] * kj, C) / sqrt_c;
      const float ex = expf(sc - m_s[i * H + h]);
      legendre(z_s[i * DK + j], pref_s, L, P);
      float s = bv;
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) {
        if (l < L) s = fmaf(P[l], G[l], s);
      }
      acc_s[i * HC + hc] = fmaf(vj * s, ex, acc_s[i * HC + hc]);
    }
  }
  for (int i = 0; i < DI; ++i) {
    const float gi = g_s[i * HC + hc];
    const float inner =
        head_sum(gi * acc_s[i * HC + hc], C) * rl_s[i * H + h];
    if (c == 0) inner_s[i * H + h] = inner;
    acc_s[i * HC + hc] = 0.f;   // becomes dq
  }
  __syncthreads();

  // ---- pass C: key-outer gradients ----
  float dG[kMaxL];
  float de_acc = 0.f, db_acc = 0.f;
  for (int j = 0; j < DK; ++j) {
    const int bj = b_s[j];
    float dk_acc = 0.f, dv_acc = 0.f;
    if (bj >= 0) {
      load_g(rbf_s + j * LK, w, L, K, HC, hc, G);
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) dG[l] = 0.f;
      const float kj = kk_s[j * HC + hc];
      const float vj = vv_s[j * HC + hc];
      for (int i = 0; i < DI; ++i) {
        const int ai = a_s[i];
        if (ai < 0 || ai == bj) continue;
        const float qi = q_s[i * HC + hc];
        const float gi = g_s[i * HC + hc];
        const float rn = rl_s[i * H + h];
        const float sc = head_sum(qi * kj, C) / sqrt_c;
        const float ex = expf(sc - m_s[i * H + h]);
        const float alpha = ex * rn;
        legendre(z_s[i * DK + j], pref_s, L, P);
        float s = bv;
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
          if (l < L) s = fmaf(P[l], G[l], s);
        }
        const float gn = gi * rn;
        const float ds = gn * vj * ex;
        dv_acc = fmaf(gn * s, ex, dv_acc);
        const float dalpha = head_sum(gi * vj * s, C);
        const float dsc = alpha * (dalpha - inner_s[i * H + h]) / sqrt_c;
        acc_s[i * HC + hc] = fmaf(dsc, kj, acc_s[i * HC + hc]);
        dk_acc = fmaf(dsc, qi, dk_acc);
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) dG[l] = fmaf(P[l], ds, dG[l]);
        db_acc += ds;
      }
      const float* rb = rbf_s + j * LK;
      for (int l = 0; l < L; ++l) {
        for (int t = 0; t < K; ++t) {
          float* dst = dw_s + (l * K + t) * HC + hc;
          *dst = fmaf(rb[l * K + t], dG[l], *dst);
        }
      }
    }
    const size_t off = (n * DK + j) * HC + hc;
    dk[off] = dk_acc;
    dv[off] = dv_acc;
    de_acc += dk_acc + dv_acc;
  }

  for (int i = 0; i < DI; ++i) {
    dq[(n * DI + i) * HC + hc] = acc_s[i * HC + hc];
  }
  de[n * HC + hc] = de_acc;
  float* part = partial + n * static_cast<size_t>(LK + 1) * HC;
  for (int t = 0; t < LK; ++t) part[t * HC + hc] = dw_s[t * HC + hc];
  part[LK * HC + hc] = db_acc;
}

// out[col] = sum over rows of partial[row, col]. Block (32, kReduceRowLanes):
// lane x owns a column of the block's 32, lane y the rows r = y mod 8, in
// increasing order; the 8 row sums are then added in y order. The order
// depends only on the shapes, so the sum is the same bit for bit run to run.
__global__ void reduce_rows_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int rows,
                                   int cols) {
  __shared__ float red[kReduceRowLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (col < cols) {
    for (int r = ty; r < rows; r += kReduceRowLanes) {
      acc += partial[static_cast<size_t>(r) * cols + col];
    }
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float t = red[0][tx];
    for (int y = 1; y < kReduceRowLanes; ++y) t += red[y][tx];
    out[col] = t;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// All pointers are device pointers to contiguous arrays:
// q/g/dq (N,DI,HC), k/v/dk/dv (N,DK,HC), e/de (N,HC), rbf (N,DK,L*K),
// w (L*K,HC), bias (HC), z (N,DI,DK), a_ids (N,DI) int32, b_ids (N,DK)
// int32, partial (N, L*K+1, HC): per atom, its dW rows then its db row.
// The caller checks shapes; N >= 1, DI and DK in 1..64, L <= 8.
int blocked_attn_bwd(const float* q, const float* k, const float* v,
                     const float* e, const float* rbf, const float* w,
                     const float* bias, const float* z, const int* a_ids,
                     const int* b_ids, const float* g, float* dq, float* dk,
                     float* dv, float* de, float* partial, int N, int DI,
                     int DK, int H, int C, int L, int K, void* stream) {
  if (L < 1 || L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = make_layout(DI, DK, H, C, L, K);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  blocked_attn_bwd_kernel<<<N, H * C, lay.bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, e, rbf, w, bias, z, a_ids, b_ids, g, dq, dk, dv, de, partial,
      DI, DK, H, C, L, K, static_cast<float>(sqrt(static_cast<double>(C))));
  return static_cast<int>(cudaGetLastError());
}

// out (cols) = partial (rows, cols) summed over rows in a fixed order.
int blocked_attn_bwd_reduce(const float* partial, float* out, int rows,
                            int cols, void* stream) {
  const dim3 block(32, kReduceRowLanes);
  const dim3 grid((cols + 31) / 32);
  reduce_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

const char* blocked_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
