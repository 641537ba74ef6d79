// ADC lower-bound distances for the batched query plane (Stage 4).
//
// Two kernels, one per Stage 4 formulation of repro/core/dataplane.py. Both
// work on the live survivors only, read through `sel` in place:
//
// adc_table  (kernel 2) replaces the TPU Pallas kernel
//   repro/kernels/adc_lookup.py::adc_lb_distances_batch (body adc_batch_kernel)
//   together with the plane's survivor gather and dead-slot mask around it
//   (repro/core/dataplane.py:419-434): tables (Q, P, M+1, d) f32, codes
//   (P, n_max, d) int32, sel (Q, P, S) int64 and keep (Q, P) int32 ->
//   (Q, P, S) f32, out[q, p, s] = sum_j T[q, p, code[sel[q, p, s], j], j],
//   optionally square-rooted, +inf at slots s >= keep[q, p]. A null `sel`
//   means row s, a null `keep` means every slot is live: the TPU kernel's own
//   (B, M+1, d) x (B, N, d) contract (adc_lookup.adc_batch) is this kernel
//   at Q = 1, P = B, and its single-table view adc_lb_distances
//   (adc_lookup.py:59) at B = 1. The TPU turned the gather into one-hot x
//   table on the MXU; that only suited the MXU. Here the gather reads the
//   table from shared memory.
//   Bound: bytes. The live slots' code rows (4 bytes a code, one shared-
//   memory lookup and one add each), their sel entries, the live pairs'
//   tables and the (Q, P, S) output, written once.
//   Design: kernel 2b's task machinery (below). Per (q, p) pair its range
//   touches, the block stages the pair's f32 table in shared memory with a
//   pitch of d + 1 (TABLE_PAD), so a warp's lookups at one dim j and
//   different codes fall in different banks; a table beyond the budget is
//   read through L2. Each lane sums its own survivor's d terms.
//
// adc_direct (kernel 2b) is the port of repro/core/dataplane.py::adc_lb_direct,
//   the tall-table Stage 4 (M+1 > 129), which the JAX package runs as plain
//   jnp gathers, not as a Pallas kernel:
//   qt (Q, P, d), qcell (Q, P, d) int32, boundaries (P, M+1, d), codes
//   (P, n_max, d) int32, sel (Q, P, S) int64 and keep (Q, P) int32 ->
//   (Q, P, S) f32 squared LB. Per live (survivor, dim): qt - b[c+1] if
//   c < qcell, b[c] - qt if c > qcell, else 0; squared in the input dtype,
//   zeroed where not finite, cast to f32. Dead slots get +inf.
//   Bound: bytes. The live survivors' code rows (4 bytes a code) and the
//   (Q, P, S) output, written once; dead pairs and slots cost one +inf store.
//   Design: per partition its range touches (usually one), the block stages
//   the partition's boundaries in shared memory (f32: 257 x 128 is 132 KB
//   with a padded pitch of d + 1), or reads them through L2 (f64, or tables
//   too large). A warp stages the pair's qt and qcell rows with its task,
//   once per pair, where eight warps' rows fit the block (ROW); at a wider
//   d it stages them a chunk of DC dims at a time, beside the codes of the
//   same dims, so a block's shared memory does not grow with d (a whole row
//   per warp outgrew the block at d = 3,072, an LM embedding's width).
//
// The task machinery both share: the live slots are cut into tasks of 32
// slots of one (q, p) pair; a first one-block launch prefix-sums the pairs'
// task counts in (partition, query) order. The grid has as many blocks as fit
// the card at once, and each takes an equal range of that task list. A warp
// takes one task at a time and stages the 32 survivors' code rows with
// cp.async (16 lanes x 16 bytes a 64-code chunk, two rows a step, every load
// in flight at once) into padded shared memory; then each lane sums its own
// survivor's d terms. Last, each block writes +inf over the dead slots of the
// (q, p) rows dealt to it.
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

constexpr int TASK_THREADS = 256;  // 8 warps, one task of 32 survivors each
constexpr int TASK_WARPS = TASK_THREADS / 32;
constexpr int DC = 64;            // codes of a row staged per pass
constexpr int LDC = DC + 4;       // staged row pitch: conflict-free 16-byte reads
constexpr int TABLE_PAD = 1;      // adc_table's table pitch is d + TABLE_PAD
constexpr size_t SMEM_LIMIT = 227 * 1024;  // one H100 block's most
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ float sq_to_f32(float diff) {
  return isfinite(diff) ? __fmul_rn(diff, diff) : 0.f;
}

__device__ __forceinline__ float sq_to_f32(double diff) {
  return isfinite(diff) ? __double2float_rn(__dmul_rn(diff, diff)) : 0.f;
}

// Live slots of pair (q, p): keep clamped to [0, S]; every slot without keep.
__device__ __forceinline__ long long live_count(const int32_t* keep, int P,
                                                long long q, long long p,
                                                long long S) {
  if (keep == nullptr) return S;
  const long long k = keep[q * P + p];
  return k < 0 ? 0 : (k > S ? S : k);
}

// off[i] = the number of 32-slot tasks of the pairs before i, in (p, q)
// order, i = p Q + q; a pair of live count k has ceil(k / 32) tasks. off[P Q]
// is the total. One block; integer sums.
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

// The last i in [0, n) with off[i * stride] <= t (off non-decreasing).
__device__ __forceinline__ int last_le(const int64_t* __restrict__ off,
                                       long long stride, int n, long long t) {
  int lo = 0;
  for (int hi = n - 1; lo < hi;) {
    const int mid = (lo + hi + 1) / 2;
    if (off[(long long)mid * stride] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
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

// Stage codes [d0, d0 + w) of the warp's 32 survivor rows (lane i's `row`
// of partition codes `cp`, where `live`) into cw (32 rows of pitch LDC):
// coalesced, all loads in flight at once (16 lanes x 16 bytes a row chunk,
// two rows a step). Returns when the chunk has landed for the whole warp;
// the caller __syncwarp()s once it has read the chunk.
template <bool VEC>
__device__ __forceinline__ void stage_code_rows(int* __restrict__ cw,
                                                const int32_t* __restrict__ cp,
                                                long long row, bool live,
                                                int d0, int w, int D,
                                                int lane) {
  const unsigned full = 0xffffffffu;
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
}

// Dead slots: +inf over each (q, p) row dealt to this block (none without
// keep).
__device__ __forceinline__ void fill_dead(float* __restrict__ out,
                                          const int32_t* __restrict__ keep,
                                          int Q, int P, long long S) {
  if (keep == nullptr) return;
  for (long long pair = blockIdx.x; pair < (long long)Q * P;
       pair += gridDim.x) {
    const long long k = live_count(keep, P, pair / P, pair % P, S);
    float* o = out + pair * S;
    for (long long s = k + threadIdx.x; s < S; s += TASK_THREADS)
      o[s] = INFINITY;
  }
}

// Shared memory a warp stages its 32 code rows of DC codes in.
constexpr size_t CODE_SMEM = (size_t)32 * LDC * sizeof(int);

template <bool TABLE_SMEM, bool VEC>
__global__ void __launch_bounds__(TASK_THREADS) adc_table_kernel(
    const float* __restrict__ tables, const int32_t* __restrict__ codes,
    const int64_t* __restrict__ sel, const int32_t* __restrict__ keep,
    const int64_t* __restrict__ off, float* __restrict__ out, int Q, int P,
    int M1, long long NMAX, int D, long long S, int do_sqrt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* cw = reinterpret_cast<int*>(smem_raw + warp * CODE_SMEM);
  float* ts = reinterpret_cast<float*>(smem_raw + TASK_WARPS * CODE_SMEM);
  const int* mine = cw + lane * LDC;              // lane's staged row
  const int pitch = D + TABLE_PAD;

  // Live tasks: an equal range of the (partition, query, 32 slots) list,
  // cut into segments of one pair each.
  const long long total = off[(long long)P * Q];
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;
  for (long long t_seg = total * blockIdx.x / gridDim.x; t_seg < t_end;) {
    const int i = last_le(off, 1, P * Q, t_seg);  // i = p Q + q
    const long long seg_end = min(t_end, (long long)off[i + 1]);
    const int p = i / Q, q = i - p * Q;
    const long long pair = (long long)q * P + p;
    const float* tb = tables + pair * M1 * D;
    if (TABLE_SMEM) {
      __syncthreads();                 // the previous pair's table is done
      for (int k = threadIdx.x; k < M1 * D; k += TASK_THREADS) {
        const int c = k / D;
        cp_async_small<4>(ts + c * pitch + (k - c * D), tb + k);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const int32_t* cp = codes + (long long)p * NMAX * D;
    const long long live_k = live_count(keep, P, q, p, S);
    for (long long t = t_seg + warp; t < seg_end; t += TASK_WARPS) {
      const long long s = (t - off[i]) * 32 + lane;
      const bool live = s < live_k;
      const long long row = !live ? 0 : (sel ? sel[pair * S + s] : s);
      float acc = 0.f;
      for (int d0 = 0; d0 < D; d0 += DC) {
        const int w = min(DC, D - d0);
        stage_code_rows<VEC>(cw, cp, row, live, d0, w, D, lane);
        if (VEC && live) {
#pragma unroll 4
          for (int jj = 0; jj < w; jj += 4) {
            const int4 c4 = *reinterpret_cast<const int4*>(mine + jj);
            const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int c = min(max(cs[u], 0), M1 - 1);
              const int j = d0 + jj + u;
              acc = __fadd_rn(acc, TABLE_SMEM ? ts[c * pitch + j]
                                              : __ldg(tb + (long long)c * D + j));
            }
          }
        } else if (live) {
          for (int jj = 0; jj < w; ++jj) {
            const int c = min(max(mine[jj], 0), M1 - 1);
            const int j = d0 + jj;
            acc = __fadd_rn(acc, TABLE_SMEM ? ts[c * pitch + j]
                                            : __ldg(tb + (long long)c * D + j));
          }
        }
        __syncwarp();                  // the chunk is consumed
      }
      if (live) out[pair * S + s] = do_sqrt ? __fsqrt_rn(acc) : acc;
    }
    t_seg = seg_end;
  }
  fill_dead(out, keep, Q, P, S);
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

// Shared memory a warp of adc_direct stages a task in: 32 code rows of DC
// codes, and the pair's qt and qcell rows (ROW: D values each) or their
// values at the same DC dims as the codes.
template <typename T, bool ROW>
__host__ __device__ constexpr size_t warp_smem(int D) {
  return (CODE_SMEM + (size_t)(ROW ? D : DC) * (sizeof(T) + 4) + 15) / 16 * 16;
}

template <typename T, bool BND_SMEM, bool VEC, bool ROW>
__global__ void __launch_bounds__(TASK_THREADS) adc_direct_kernel(
    const T* __restrict__ qt, const int32_t* __restrict__ qcell,
    const T* __restrict__ bnd, const int32_t* __restrict__ codes,
    const int64_t* __restrict__ sel, const int32_t* __restrict__ keep,
    const int64_t* __restrict__ off, float* __restrict__ out, int Q, int P,
    int M1, long long NMAX, int D, long long S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine_raw = smem_raw + warp * warp_smem<T, ROW>(D);
  int* cw = reinterpret_cast<int*>(mine_raw);               // (32, LDC) codes
  T* qs = reinterpret_cast<T*>(cw + 32 * LDC);    // (D) qt row or (DC) chunk
  int* qc = reinterpret_cast<int*>(qs + (ROW ? D : DC));    // qcell likewise
  T* bs = reinterpret_cast<T*>(smem_raw + TASK_WARPS * warp_smem<T, ROW>(D));
  const int* mine = cw + lane * LDC;                        // lane's row

  // Live tasks: an equal range of the (partition, query, 32 slots) list.
  const long long total = off[(long long)P * Q];
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;
  long long staged_pair = -1;          // ROW: the pair whose rows qs/qc hold
  for (long long t_seg = total * blockIdx.x / gridDim.x; t_seg < t_end;) {
    const int p = last_le(off, Q, P, t_seg);
    const long long seg_end =
        min(t_end, (long long)off[(long long)(p + 1) * Q]);
    const T* bp = bnd + (long long)p * M1 * D;
    if (BND_SMEM) {
      __syncthreads();                 // the previous partition is done
      for (int i = threadIdx.x; i < M1 * D; i += TASK_THREADS) {
        const int c = i / D;
        cp_async_small<sizeof(T)>(bs + c * (D + 1) + (i - c * D), bp + i);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const int64_t* offp = off + (long long)p * Q;
    const int32_t* cp = codes + (long long)p * NMAX * D;
    for (long long t = t_seg + warp; t < seg_end; t += TASK_WARPS) {
      const int q = last_le(offp, 1, Q, t);
      const long long pair = (long long)q * P + p;
      const long long s = (t - offp[q]) * 32 + lane;
      const bool live = s < live_count(keep, P, q, p, S);
      const long long row = live ? sel[pair * S + s] : 0;
      const T* qrow = qt + pair * D;
      const int32_t* crow = qcell + pair * D;
      if (ROW) {
        __syncwarp();                  // the previous task's reads are done
        if (pair != staged_pair) {     // lands with the first code chunk
          for (int j = lane; j < D; j += 32) {
            cp_async_small<sizeof(T)>(qs + j, qrow + j);
            cp_async_small<4>(qc + j, crow + j);
          }
          staged_pair = pair;
        }
      }
      float acc = 0.f;
      for (int d0 = 0; d0 < D; d0 += DC) {
        const int w = min(DC, D - d0);
        if (!ROW) {
          for (int jj = lane; jj < w; jj += 32) {  // lands with the codes
            cp_async_small<sizeof(T)>(qs + jj, qrow + d0 + jj);
            cp_async_small<4>(qc + jj, crow + d0 + jj);
          }
        }
        stage_code_rows<VEC>(cw, cp, row, live, d0, w, D, lane);
        const T* qv = qs + (ROW ? d0 : 0);          // dims d0 .. d0 + w
        const int* qcv = qc + (ROW ? d0 : 0);
        if (live) {
          if (VEC) {
#pragma unroll 4
            for (int jj = 0; jj < w; jj += 4) {
              const int j = d0 + jj;
              const int4 c4 = *reinterpret_cast<const int4*>(mine + jj);
              const int4 q4 = *reinterpret_cast<const int4*>(qcv + jj);
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.x, q4.x, qv[jj], bs, bp, j, M1, D));
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.y, q4.y, qv[jj + 1], bs, bp, j + 1, M1, D));
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.z, q4.z, qv[jj + 2], bs, bp, j + 2, M1, D));
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  c4.w, q4.w, qv[jj + 3], bs, bp, j + 3, M1, D));
            }
          } else {
            for (int jj = 0; jj < w; ++jj) {
              const int j = d0 + jj;
              acc = __fadd_rn(acc, direct_term<T, BND_SMEM>(
                  mine[jj], qcv[jj], qv[jj], bs, bp, j, M1, D));
            }
          }
        }
        __syncwarp();                  // the chunk is consumed
      }
      if (live) out[pair * S + s] = acc;
    }
    t_seg = seg_end;
  }
  fill_dead(out, keep, Q, P, S);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The two launches of a task kernel on stream s: the task-count prefix sum
// into `off`, then `kernel` with `smem` bytes of dynamic shared memory on as
// many blocks as fit the card at once. Returns the cudaError_t (0 = success).
template <typename... KArgs, typename... Args>
int launch_tasks(void (*kernel)(KArgs...), size_t smem, const void* keep,
                 void* off, int Q, int P, long long S, cudaStream_t s,
                 Args... args) {
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
                                                    TASK_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = std::max(1LL, std::min<long long>(
      (long long)sms * std::max(per_sm, 1), (long long)Q * P * S));
  kernel<<<(unsigned)blocks, TASK_THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// Shared memory of one adc_table block: each warp's code rows, plus one
// pair's table at pitch D + TABLE_PAD when it is staged.
size_t table_smem(int M1, int D, bool table_in_smem) {
  return TASK_WARPS * CODE_SMEM +
         (table_in_smem ? (size_t)M1 * (D + TABLE_PAD) * sizeof(float) : 0);
}

template <bool TABLE_SMEM, bool VEC>
int adc_table_run(const void* tables, const void* codes, const void* sel,
                  const void* keep, void* off, void* out, int Q, int P, int M1,
                  long long NMAX, int D, long long S, int do_sqrt,
                  cudaStream_t s) {
  return launch_tasks(
      adc_table_kernel<TABLE_SMEM, VEC>, table_smem(M1, D, TABLE_SMEM), keep,
      off, Q, P, S, s, static_cast<const float*>(tables),
      static_cast<const int32_t*>(codes), static_cast<const int64_t*>(sel),
      static_cast<const int32_t*>(keep), static_cast<const int64_t*>(off),
      static_cast<float*>(out), Q, P, M1, NMAX, D, S, do_sqrt);
}

// Shared memory of one adc_direct block: each warp's staging, plus one
// partition's boundaries when they are staged.
template <typename T, bool ROW>
size_t direct_smem(int M1, int D, bool bnd_smem) {
  return TASK_WARPS * warp_smem<T, ROW>(D) +
         (bnd_smem ? (size_t)M1 * (D + 1) * sizeof(T) : 0);
}

// How adc_direct stages at these sizes: whole query rows where eight warps'
// rows fit the block, and then the boundaries too where they also fit (f32
// only); else chunks of the rows and no boundaries.
struct DirectPlan {
  bool row, bnd;
  size_t smem;
};

DirectPlan direct_plan(int M1, int D, int is_double) {
  const size_t esz = is_double ? sizeof(double) : sizeof(float);
  const size_t warp_row = (CODE_SMEM + (size_t)D * (esz + 4) + 15) / 16 * 16;
  if (TASK_WARPS * warp_row > SMEM_LIMIT) {
    return {false, false,
            is_double ? direct_smem<double, false>(M1, D, false)
                      : direct_smem<float, false>(M1, D, false)};
  }
  if (!is_double && direct_smem<float, true>(M1, D, true) <= SMEM_LIMIT)
    return {true, true, direct_smem<float, true>(M1, D, true)};
  return {true, false,
          is_double ? direct_smem<double, true>(M1, D, false)
                    : direct_smem<float, true>(M1, D, false)};
}

template <typename T, bool BND_SMEM, bool VEC, bool ROW>
int adc_direct_run(const void* qt, const void* qcell, const void* bnd,
                   const void* codes, const void* sel, const void* keep,
                   void* off, void* out, int Q, int P, int M1, long long NMAX,
                   int D, long long S, cudaStream_t s) {
  return launch_tasks(
      adc_direct_kernel<T, BND_SMEM, VEC, ROW>,
      direct_smem<T, ROW>(M1, D, BND_SMEM),
      keep, off, Q, P, S, s, static_cast<const T*>(qt),
      static_cast<const int32_t*>(qcell), static_cast<const T*>(bnd),
      static_cast<const int32_t*>(codes), static_cast<const int64_t*>(sel),
      static_cast<const int32_t*>(keep), static_cast<const int64_t*>(off),
      static_cast<float*>(out), Q, P, M1, NMAX, D, S);
}

template <typename T, bool BND_SMEM, bool ROW>
int adc_direct_vec(bool vec, const void* qt, const void* qcell,
                   const void* bnd, const void* codes, const void* sel,
                   const void* keep, void* off, void* out, int Q, int P,
                   int M1, long long NMAX, int D, long long S,
                   cudaStream_t s) {
  return vec ? adc_direct_run<T, BND_SMEM, true, ROW>(
                   qt, qcell, bnd, codes, sel, keep, off, out, Q, P, M1,
                   NMAX, D, S, s)
             : adc_direct_run<T, BND_SMEM, false, ROW>(
                   qt, qcell, bnd, codes, sel, keep, off, out, Q, P, M1,
                   NMAX, D, S, s);
}

}  // namespace

// tables (Q, P, M1, D) f32; codes (P, NMAX, D) int32; sel (Q, P, S) int64
// or null (row s); keep (Q, P) int32 or null (all S live); off (P Q + 1)
// int64: scratch the first launch fills with the pairs' task offsets for the
// second. Launches on `stream`; returns the cudaError_t of the launches
// (0 = success).
extern "C" int adc_table_launch(const void* tables, const void* codes,
                                const void* sel, const void* keep, void* off,
                                void* out, int Q, int P, int M1,
                                long long NMAX, int D, long long S,
                                int do_sqrt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && aligned16(codes);
  const bool table_in_smem = table_smem(M1, D, true) <= SMEM_LIMIT;
  if (table_in_smem) {
    return vec ? adc_table_run<true, true>(tables, codes, sel, keep, off, out,
                                           Q, P, M1, NMAX, D, S, do_sqrt, s)
               : adc_table_run<true, false>(tables, codes, sel, keep, off,
                                            out, Q, P, M1, NMAX, D, S,
                                            do_sqrt, s);
  }
  return vec ? adc_table_run<false, true>(tables, codes, sel, keep, off, out,
                                          Q, P, M1, NMAX, D, S, do_sqrt, s)
             : adc_table_run<false, false>(tables, codes, sel, keep, off, out,
                                           Q, P, M1, NMAX, D, S, do_sqrt, s);
}

// keep (Q, P) int32: live counts; off (P Q + 1) int64: scratch the first
// launch fills with the pairs' task offsets for the second. Launches on
// `stream`; returns the cudaError_t of the launches (0 = success).
extern "C" int adc_direct_launch(const void* qt, const void* qcell,
                                 const void* bnd, const void* codes,
                                 const void* sel, const void* keep, void* off,
                                 void* out, int Q, int P, int M1,
                                 long long NMAX, int D, long long S,
                                 int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && aligned16(codes);
  const DirectPlan plan = direct_plan(M1, D, is_double);
  if (is_double) {
    return plan.row
               ? adc_direct_vec<double, false, true>(vec, qt, qcell, bnd,
                                                     codes, sel, keep, off,
                                                     out, Q, P, M1, NMAX, D,
                                                     S, s)
               : adc_direct_vec<double, false, false>(vec, qt, qcell, bnd,
                                                      codes, sel, keep, off,
                                                      out, Q, P, M1, NMAX, D,
                                                      S, s);
  }
  if (plan.bnd) {
    return adc_direct_vec<float, true, true>(vec, qt, qcell, bnd, codes, sel,
                                             keep, off, out, Q, P, M1, NMAX,
                                             D, S, s);
  }
  return plan.row
             ? adc_direct_vec<float, false, true>(vec, qt, qcell, bnd, codes,
                                                  sel, keep, off, out, Q, P,
                                                  M1, NMAX, D, S, s)
             : adc_direct_vec<float, false, false>(vec, qt, qcell, bnd,
                                                   codes, sel, keep, off, out,
                                                   Q, P, M1, NMAX, D, S, s);
}

// Dynamic shared memory one adc_direct block asks for at these sizes; the
// wrapper refuses a launch that would exceed SMEM_LIMIT before making it.
extern "C" long long adc_direct_smem_bytes(int M1, int D, int is_double) {
  return (long long)direct_plan(M1, D, is_double).smem;
}
