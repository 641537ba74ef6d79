// ADC lower-bound distances for the batched query plane (Stage 4).
//
// Two kernels, one per Stage 4 formulation of repro/core/dataplane.py:
//
// adc_batch  (kernel 2) replaces the TPU Pallas kernel
//   repro/kernels/adc_lookup.py::adc_lb_distances_batch (body adc_batch_kernel):
//   (B, M+1, d) f32 tables x (B, N, d) int32 codes -> (B, N) f32,
//   out[b, i] = sum_j T[b, code[b, i, j], j], optionally square-rooted. The
//   single-table view adc_lb_distances (adc_lookup.py:59) is this kernel at B=1.
//   The TPU turned the gather into one-hot x table on the MXU; that only
//   suited the MXU. Here the gather reads the table from shared memory.
//   Bound: bytes. Each code is read once (4 bytes) for one shared-memory load
//   and one add; at the plane's shapes the (B, N, d) codes dominate the bytes.
//   Design: one block per (b, tile of 256 rows). The block stages table b in
//   shared memory, in tiles of DT dims when (M+1) * d * 4 bytes exceeds the
//   budget (the TPU grid's BLOCK_D); above 48 KB the launcher raises the
//   dynamic shared-memory limit. Each thread owns one row, reads its codes
//   with 16-byte loads where aligned, and sums in f32 over ascending j.
//
// adc_direct (kernel 2b) is the port of repro/core/dataplane.py::adc_lb_direct,
//   the tall-table Stage 4 (M+1 > 129), which the JAX package runs as plain
//   jnp gathers, not as a Pallas kernel:
//   qt (Q, P, d), qcell (Q, P, d) int32, boundaries (P, M+1, d), codes
//   (P, n_max, d) int32 and sel (Q, P, S) int64 -> (Q, P, S) f32 squared LB.
//   Per (survivor, dim): qt - b[c+1] if c < qcell, b[c] - qt if c > qcell,
//   else 0; squared in the input dtype, zeroed where not finite, cast to f32.
//   Bound: bytes. Each survivor reads its d codes (4 bytes each) through sel,
//   so the (Q, P, S, d) gathered-codes tensor of the plain version is never
//   materialized; the boundary gathers hit L2 (one partition's boundaries are
//   131 KB in f32 at M+1 = 257, all ten 1.3-2.6 MB), not staged in shared
//   memory.
//   Design: one block per ((q, p) pair, tile of 128 survivors). The pair's
//   qt and qcell rows sit in shared memory; each thread owns one survivor,
//   reads its row index from sel and its codes with 16-byte loads where
//   aligned, and sums in f32 over ascending j.
//
// Sum order: both kernels add the d terms in one fixed order, ascending j,
// with __fadd_rn (no contraction into FMA), so a row's sum does not depend on
// the launch shape. The plain PyTorch versions reduce in torch.sum's order,
// hence the f32 sum-order tolerance between the two (rtol 1e-5).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS_TABLE = 256;   // rows per block, adc_batch
constexpr int ROWS_DIRECT = 128;  // survivors per block, adc_direct

template <bool VEC>
__global__ void __launch_bounds__(ROWS_TABLE) adc_batch_kernel(
    const float* __restrict__ tables, const int32_t* __restrict__ codes,
    float* __restrict__ out, int M1, long long N, int D, int DT,
    long long tiles, int do_sqrt) {
  extern __shared__ float ts[];  // (M1, DT) columns j0 .. j0+DT of table b
  const long long b = blockIdx.x / tiles;
  const long long n = (blockIdx.x % tiles) * ROWS_TABLE + threadIdx.x;
  const bool live = n < N;
  const float* tb = tables + b * (long long)M1 * D;
  const int32_t* row = codes + (b * N + (live ? n : 0)) * (long long)D;
  float acc = 0.f;
  for (int j0 = 0; j0 < D; j0 += DT) {
    const int w = min(DT, D - j0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < M1 * w; i += ROWS_TABLE) {
      const int c = i / w;
      const int jj = i - c * w;
      ts[c * DT + jj] = tb[(long long)c * D + j0 + jj];
    }
    __syncthreads();
    if (!live) continue;
    if (VEC) {
      for (int jj = 0; jj < w; jj += 4) {
        const int4 c4 = __ldg(reinterpret_cast<const int4*>(row + j0 + jj));
        const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = min(max(cs[u], 0), M1 - 1);
          acc = __fadd_rn(acc, ts[c * DT + jj + u]);
        }
      }
    } else {
      for (int jj = 0; jj < w; ++jj) {
        const int c = min(max(__ldg(row + j0 + jj), 0), M1 - 1);
        acc = __fadd_rn(acc, ts[c * DT + jj]);
      }
    }
  }
  if (live) out[b * N + n] = do_sqrt ? __fsqrt_rn(acc) : acc;
}

__device__ __forceinline__ float sq_to_f32(float diff) {
  return isfinite(diff) ? __fmul_rn(diff, diff) : 0.f;
}

__device__ __forceinline__ float sq_to_f32(double diff) {
  return isfinite(diff) ? __double2float_rn(__dmul_rn(diff, diff)) : 0.f;
}

template <typename T>
__device__ __forceinline__ float direct_term(int c, int cq, T qv,
                                             const T* __restrict__ bp, int j,
                                             int M1, int D) {
  T diff;
  if (c < cq) {
    const int i = min(max(c + 1, 0), M1 - 1);
    diff = qv - __ldg(bp + (long long)i * D + j);
  } else if (c > cq) {
    const int i = min(max(c, 0), M1 - 1);
    diff = __ldg(bp + (long long)i * D + j) - qv;
  } else {
    diff = T(0);
  }
  return sq_to_f32(diff);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(ROWS_DIRECT) adc_direct_kernel(
    const T* __restrict__ qt, const int32_t* __restrict__ qcell,
    const T* __restrict__ bnd, const int32_t* __restrict__ codes,
    const int64_t* __restrict__ sel, float* __restrict__ out, int P, int M1,
    long long NMAX, int D, long long S, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);         // (D) this pair's qt
  int* qc = reinterpret_cast<int*>(qs + D);       // (D) this pair's qcell
  const long long pair = blockIdx.x / tiles;      // q * P + p
  const int p = (int)(pair % P);
  const long long s = (blockIdx.x % tiles) * ROWS_DIRECT + threadIdx.x;
  for (int j = threadIdx.x; j < D; j += ROWS_DIRECT) {
    qs[j] = qt[pair * D + j];
    qc[j] = qcell[pair * D + j];
  }
  __syncthreads();
  if (s >= S) return;
  const long long r = sel[pair * S + s];
  const int32_t* row = codes + ((long long)p * NMAX + r) * D;
  const T* bp = bnd + (long long)p * M1 * D;
  float acc = 0.f;
  if (VEC) {
    for (int j = 0; j < D; j += 4) {
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(row + j));
      acc = __fadd_rn(acc, direct_term<T>(c4.x, qc[j], qs[j], bp, j, M1, D));
      acc = __fadd_rn(acc, direct_term<T>(c4.y, qc[j + 1], qs[j + 1], bp, j + 1, M1, D));
      acc = __fadd_rn(acc, direct_term<T>(c4.z, qc[j + 2], qs[j + 2], bp, j + 2, M1, D));
      acc = __fadd_rn(acc, direct_term<T>(c4.w, qc[j + 3], qs[j + 3], bp, j + 3, M1, D));
    }
  } else {
    for (int j = 0; j < D; ++j) {
      acc = __fadd_rn(acc, direct_term<T>(__ldg(row + j), qc[j], qs[j], bp, j, M1, D));
    }
  }
  out[pair * S + s] = acc;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `dt` is the dim-tile width the caller sized to fit `smem_bytes`.
extern "C" int adc_batch_launch(const void* tables, const void* codes,
                                void* out, long long B, int M1, long long N,
                                int D, int DT, int do_sqrt, void* stream) {
  const long long tiles = (N + ROWS_TABLE - 1) / ROWS_TABLE;
  const size_t smem = (size_t)M1 * DT * sizeof(float);
  const bool vec = (D % 4 == 0) && (DT % 4 == 0) && aligned16(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    cudaFuncSetAttribute(adc_batch_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    adc_batch_kernel<true><<<(unsigned)(B * tiles), ROWS_TABLE, smem, s>>>(
        static_cast<const float*>(tables), static_cast<const int32_t*>(codes),
        static_cast<float*>(out), M1, N, D, DT, tiles, do_sqrt);
  } else {
    cudaFuncSetAttribute(adc_batch_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    adc_batch_kernel<false><<<(unsigned)(B * tiles), ROWS_TABLE, smem, s>>>(
        static_cast<const float*>(tables), static_cast<const int32_t*>(codes),
        static_cast<float*>(out), M1, N, D, DT, tiles, do_sqrt);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int adc_direct_typed(const void* qt, const void* qcell, const void* bnd,
                     const void* codes, const void* sel, void* out, int Q,
                     int P, int M1, long long NMAX, int D, long long S,
                     cudaStream_t s) {
  const long long tiles = (S + ROWS_DIRECT - 1) / ROWS_DIRECT;
  const size_t smem = (size_t)D * (sizeof(T) + sizeof(int));
  const unsigned blocks = (unsigned)((long long)Q * P * tiles);
  const bool vec = (D % 4 == 0) && aligned16(codes);
  if (vec) {
    adc_direct_kernel<T, true><<<blocks, ROWS_DIRECT, smem, s>>>(
        static_cast<const T*>(qt), static_cast<const int32_t*>(qcell),
        static_cast<const T*>(bnd), static_cast<const int32_t*>(codes),
        static_cast<const int64_t*>(sel), static_cast<float*>(out), P, M1,
        NMAX, D, S, tiles);
  } else {
    adc_direct_kernel<T, false><<<blocks, ROWS_DIRECT, smem, s>>>(
        static_cast<const T*>(qt), static_cast<const int32_t*>(qcell),
        static_cast<const T*>(bnd), static_cast<const int32_t*>(codes),
        static_cast<const int64_t*>(sel), static_cast<float*>(out), P, M1,
        NMAX, D, S, tiles);
  }
  return (int)cudaGetLastError();
}

extern "C" int adc_direct_launch(const void* qt, const void* qcell,
                                 const void* bnd, const void* codes,
                                 const void* sel, void* out, int Q, int P,
                                 int M1, long long NMAX, int D, long long S,
                                 int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return adc_direct_typed<double>(qt, qcell, bnd, codes, sel, out, Q, P, M1,
                                    NMAX, D, S, s);
  }
  return adc_direct_typed<float>(qt, qcell, bnd, codes, sel, out, Q, P, M1,
                                 NMAX, D, S, s);
}
