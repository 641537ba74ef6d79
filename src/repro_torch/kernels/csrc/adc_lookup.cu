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
//   (P, n_max, d) int32, sel (Q, P, S) int64 and keep (Q, P) int32 ->
//   (Q, P, S) f32 squared LB. Slot s of pair (q, p) is live when
//   s < keep[q, p]; dead slots get +inf. Per live
//   (survivor, dim): qt - b[c+1] if c < qcell, b[c] - qt if c > qcell, else
//   0; squared in the input dtype, zeroed where not finite, cast to f32.
//   Bound: bytes. The live survivors' code rows (4 bytes a code) and the
//   (Q, P, S) output, written once; dead pairs and slots cost one +inf store.
//   Design: the live slots are cut into tasks of 32 slots of one (q, p) pair;
//   a first one-block launch prefix-sums the pairs' task counts in
//   (partition, query) order. The grid has as many blocks as fit the card at
//   once, and each takes an equal range of that task list. Per partition
//   its range touches (usually one), the block stages the partition's
//   boundaries in shared memory (f32: 257 x 128 is 132 KB with a padded
//   pitch of d + 1, so a warp's reads of one dim j at different cells fall
//   in different banks), or reads them through L2 (f64, or tables too
//   large). A warp takes one task at a time: it stages the pair's qt and
//   qcell rows, and the 32 survivors' code rows with cp.async (16 lanes x 16
//   bytes a 64-code chunk, two rows a step, every load in flight at once)
//   into padded shared memory; then each lane sums its own survivor's d
//   terms. Last, each block writes +inf over the dead slots of the (q, p)
//   rows dealt to it.
//
// Sum order: both kernels add the d terms in one fixed order, ascending j,
// with __fadd_rn (no contraction into FMA), so a row's sum does not depend on
// the launch shape. The plain PyTorch versions reduce in torch.sum's order,
// hence the f32 sum-order tolerance between the two (rtol 1e-5).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int ROWS_TABLE = 256;   // rows per block, adc_batch
constexpr int DIRECT_THREADS = 256;  // adc_direct: 8 warps of 32 survivors
constexpr int DIRECT_WARPS = DIRECT_THREADS / 32;
constexpr int DC = 64;            // codes of a row staged per pass
constexpr int LDC = DC + 4;       // staged row pitch: conflict-free 16-byte reads
constexpr size_t DIRECT_SMEM_LIMIT = 227 * 1024;  // one H100 block's most

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

constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ long long live_count(const int32_t* keep, int P,
                                                long long q, long long p,
                                                long long S) {
  const long long k = keep[q * P + p];
  return k < 0 ? 0 : (k > S ? S : k);
}

// off[i] = the number of 32-slot tasks of the pairs before i, in (p, q)
// order, i = p Q + q; a pair of live count k (keep clamped to [0, S]) has
// ceil(k / 32) tasks. off[P Q] is the total. One block; integer sums.
__global__ void __launch_bounds__(SCAN_THREADS) live_tasks_kernel(
    const int32_t* __restrict__ keep, int Q, int P, long long S,
    int64_t* __restrict__ off) {
  __shared__ long long warp_sum[SCAN_THREADS / 32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long n = (long long)Q * P;
  const long long per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long i0 = min(n, threadIdx.x * per), i1 = min(n, i0 + per);
  auto tasks = [&](long long i) {
    return (live_count(keep, P, i % Q, i / Q, S) + 31) / 32;
  };
  long long local = 0;
  for (long long i = i0; i < i1; ++i) local += tasks(i);
  long long incl = local;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const long long up = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const long long up = __shfl_up_sync(full, w, o);
      if (lane >= o) w += up;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  long long run = incl - local + (warp ? warp_sum[warp - 1] : 0);
  for (long long i = i0; i < i1; ++i) {
    off[i] = run;
    run += tasks(i);
  }
  if (threadIdx.x == SCAN_THREADS - 1) off[n] = run;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca copies 4 or 8 bytes");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <typename T, bool BND_SMEM>
__device__ __forceinline__ float direct_term(int c, int cq, T qv,
                                             const T* __restrict__ bs,
                                             const T* __restrict__ bp, int j,
                                             int M1, int D) {
  if (c == cq) return 0.f;
  const int i = min(max(c < cq ? c + 1 : c, 0), M1 - 1);
  const T b = BND_SMEM ? bs[i * (D + 1) + j] : __ldg(bp + (long long)i * D + j);
  return sq_to_f32(c < cq ? qv - b : b - qv);
}

// Shared memory a warp stages a task in: 32 code rows of DC codes, and the
// pair's qt and qcell rows (D each).
template <typename T>
__host__ __device__ constexpr size_t warp_smem(int D) {
  return ((size_t)32 * LDC * sizeof(int) + (size_t)D * (sizeof(T) + 4) + 15) /
         16 * 16;
}

template <typename T, bool BND_SMEM, bool VEC>
__global__ void __launch_bounds__(DIRECT_THREADS) adc_direct_kernel(
    const T* __restrict__ qt, const int32_t* __restrict__ qcell,
    const T* __restrict__ bnd, const int32_t* __restrict__ codes,
    const int64_t* __restrict__ sel, const int32_t* __restrict__ keep,
    const int64_t* __restrict__ off, float* __restrict__ out, int Q, int P,
    int M1, long long NMAX, int D, long long S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine_raw = smem_raw + warp * warp_smem<T>(D);
  int* cw = reinterpret_cast<int*>(mine_raw);               // (32, LDC) codes
  T* qs = reinterpret_cast<T*>(cw + 32 * LDC);              // (D) qt row
  int* qc = reinterpret_cast<int*>(qs + D);                 // (D) qcell row
  T* bs = reinterpret_cast<T*>(smem_raw + DIRECT_WARPS * warp_smem<T>(D));
  const int* mine = cw + lane * LDC;                        // lane's row
  const unsigned full = 0xffffffffu;

  // Live tasks: an equal range of the (partition, query, 32 slots) list.
  const long long total = off[(long long)P * Q];
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;
  long long staged_pair = -1;          // the pair whose qt/qcell qs/qc hold
  for (long long t_seg = total * blockIdx.x / gridDim.x; t_seg < t_end;) {
    int p = 0;                         // the last p with off[p Q] <= t_seg
    for (int hi = P - 1; p < hi;) {
      const int mid = (p + hi + 1) / 2;
      if (off[(long long)mid * Q] <= t_seg) p = mid; else hi = mid - 1;
    }
    const long long seg_end =
        min(t_end, (long long)off[(long long)(p + 1) * Q]);
    const T* bp = bnd + (long long)p * M1 * D;
    if (BND_SMEM) {
      __syncthreads();                 // the previous partition is done
      for (int i = threadIdx.x; i < M1 * D; i += DIRECT_THREADS) {
        const int c = i / D;
        cp_async_small<sizeof(T)>(bs + c * (D + 1) + (i - c * D), bp + i);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const int64_t* offp = off + (long long)p * Q;
    const int32_t* cp = codes + (long long)p * NMAX * D;
    for (long long t = t_seg + warp; t < seg_end; t += DIRECT_WARPS) {
      int q = 0;                       // the last q with offp[q] <= t
      for (int hi = Q - 1; q < hi;) {
        const int mid = (q + hi + 1) / 2;
        if (offp[mid] <= t) q = mid; else hi = mid - 1;
      }
      const long long pair = (long long)q * P + p;
      const long long s = (t - offp[q]) * 32 + lane;
      const bool live = s < live_count(keep, P, q, p, S);
      const long long row = live ? sel[pair * S + s] : 0;
      __syncwarp();                    // the previous task's reads are done
      if (pair != staged_pair) {        // lands with the first code chunk
        for (int j = lane; j < D; j += 32) {
          cp_async_small<sizeof(T)>(qs + j, qt + pair * D + j);
          cp_async_small<4>(qc + j, qcell + pair * D + j);
        }
        staged_pair = pair;
      }
      float acc = 0.f;
      for (int d0 = 0; d0 < D; d0 += DC) {
        const int w = min(DC, D - d0);
        // Stage the task's code rows [d0, d0 + w): coalesced, all loads in
        // flight at once (16 lanes x 16 bytes a row chunk, two rows a step).
        if (VEC) {
          const int col = (lane % 16) * 4;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int rr = 2 * k + lane / 16;
            const long long r_row = __shfl_sync(full, row, rr);
            const bool r_live = __shfl_sync(full, live, rr);
            if (r_live && col < w)
              cp_async16(cw + rr * LDC + col, cp + r_row * D + d0 + col);
          }
        } else {
          for (int rr = 0; rr < 32; ++rr) {
            const long long r_row = __shfl_sync(full, row, rr);
            const bool r_live = __shfl_sync(full, live, rr);
            for (int col = lane; col < w; col += 32)
              if (r_live) cp_async_small<4>(cw + rr * LDC + col,
                                  cp + r_row * D + d0 + col);
          }
        }
        cp_async_wait_all();
        __syncwarp();
        if (live) {
          if (VEC) {
#pragma unroll 4
            for (int jj = 0; jj < w; jj += 4) {
              const int j = d0 + jj;
              const int4 c4 = *reinterpret_cast<const int4*>(mine + jj);
              const int4 q4 = *reinterpret_cast<const int4*>(qc + j);
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.x, q4.x, qs[j], bs, bp, j, M1, D));
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.y, q4.y, qs[j + 1], bs, bp, j + 1, M1, D));
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.z, q4.z, qs[j + 2], bs, bp, j + 2, M1, D));
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.w, q4.w, qs[j + 3], bs, bp, j + 3, M1, D));
            }
          } else {
            for (int jj = 0; jj < w; ++jj) {
              const int j = d0 + jj;
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  mine[jj], qc[j], qs[j], bs, bp, j, M1, D));
            }
          }
        }
        __syncwarp();                  // the chunk is consumed
      }
      if (live) out[pair * S + s] = acc;
    }
    t_seg = seg_end;
  }

  // Dead slots: +inf over each (q, p) row dealt to this block.
  for (long long pair = blockIdx.x; pair < (long long)Q * P;
       pair += gridDim.x) {
    const long long k = live_count(keep, P, pair / P, pair % P, S);
    float* o = out + pair * S;
    for (long long s = k + threadIdx.x; s < S; s += DIRECT_THREADS)
      o[s] = INFINITY;
  }
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

namespace {

// Shared memory of one adc_direct block: each warp's staging, plus one
// partition's boundaries when they are staged.
template <typename T>
size_t direct_smem(int M1, int D, bool bnd_smem) {
  return DIRECT_WARPS * warp_smem<T>(D) +
         (bnd_smem ? (size_t)M1 * (D + 1) * sizeof(T) : 0);
}

template <typename T, bool BND_SMEM, bool VEC>
int adc_direct_run(const void* qt, const void* qcell, const void* bnd,
                   const void* codes, const void* sel, const void* keep,
                   void* off, void* out, int Q, int P, int M1, long long NMAX,
                   int D, long long S, cudaStream_t s) {
  const auto kernel = adc_direct_kernel<T, BND_SMEM, VEC>;
  const size_t smem = direct_smem<T>(M1, D, BND_SMEM);
  live_tasks_kernel<<<1, SCAN_THREADS, 0, s>>>(
      static_cast<const int32_t*>(keep), Q, P, S, static_cast<int64_t*>(off));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    DIRECT_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = std::max(1LL, std::min<long long>(
      (long long)sms * std::max(per_sm, 1), (long long)Q * P * S));
  kernel<<<(unsigned)blocks, DIRECT_THREADS, smem, s>>>(
      static_cast<const T*>(qt), static_cast<const int32_t*>(qcell),
      static_cast<const T*>(bnd), static_cast<const int32_t*>(codes),
      static_cast<const int64_t*>(sel), static_cast<const int32_t*>(keep),
      static_cast<const int64_t*>(off), static_cast<float*>(out), Q, P, M1,
      NMAX, D, S);
  return (int)cudaGetLastError();
}

template <typename T, bool BND_SMEM>
int adc_direct_vec(bool vec, const void* qt, const void* qcell,
                   const void* bnd, const void* codes, const void* sel,
                   const void* keep, void* off, void* out, int Q, int P,
                   int M1, long long NMAX, int D, long long S,
                   cudaStream_t s) {
  return vec ? adc_direct_run<T, BND_SMEM, true>(qt, qcell, bnd, codes, sel,
                                                 keep, off, out, Q, P, M1,
                                                 NMAX, D, S, s)
             : adc_direct_run<T, BND_SMEM, false>(qt, qcell, bnd, codes, sel,
                                                  keep, off, out, Q, P, M1,
                                                  NMAX, D, S, s);
}

}  // namespace

// keep (Q, P) int32: live counts; off (P Q + 1) int64: scratch the first
// launch fills with the pairs' task offsets for the second. Launches on `stream`; returns the cudaError_t of
// the launches (0 = success).
extern "C" int adc_direct_launch(const void* qt, const void* qcell,
                                 const void* bnd, const void* codes,
                                 const void* sel, const void* keep, void* off,
                                 void* out, int Q, int P, int M1,
                                 long long NMAX, int D, long long S,
                                 int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && aligned16(codes);
  if (is_double) {
    return adc_direct_vec<double, false>(vec, qt, qcell, bnd, codes, sel, keep,
                                         off, out, Q, P, M1, NMAX, D, S, s);
  }
  if (direct_smem<float>(M1, D, true) <= DIRECT_SMEM_LIMIT) {
    return adc_direct_vec<float, true>(vec, qt, qcell, bnd, codes, sel, keep,
                                       off, out, Q, P, M1, NMAX, D, S, s);
  }
  return adc_direct_vec<float, false>(vec, qt, qcell, bnd, codes, sel, keep,
                                      off, out, Q, P, M1, NMAX, D, S, s);
}
