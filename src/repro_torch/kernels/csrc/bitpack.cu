// OSQ dimensional extraction, paper section 2.2.2 (kernel 5).
//
// Replaces the TPU Pallas kernel repro/kernels/bitpack.py::extract_codes (body
// built by make_extract_kernel):
//   (N, G) packed S-bit segments (S = 8, 16 or 32) -> (N, d) int32 codes,
//   code[r, j] = OR over the pieces of dim j of
//                ((seg[r, piece.seg] >> piece.rshift) & mask(piece.nbits))
//                << piece.lshift.
// The TPU bakes the per-dimension plan (SegmentLayout.plans) into the kernel
// body at trace time. Here the plan is data: the wrapper uploads it once per
// layout as a table of pieces (seg, rshift, nbits, lshift) and each dim's
// first piece. Nothing is generated at run time; one build serves every
// layout.
//
// What bounds it on an H100: bytes. Each row reads G * S / 8 bytes and
// writes 4 d bytes (at the index's shapes, G = 64 one-byte segments and
// d = 128: 64 bytes in, 512 out), against a few integer operations per piece.
//
// Design: each thread owns one group of 4 consecutive dims and loads their
// pieces into registers once (MAXP = 2 or 3 pieces a dim at most, the
// instantiation the layout needs), then walks rows: a row's groups lie on neighbouring
// threads, so each row goes out as whole 16-byte stores, a warp writing 512
// contiguous bytes at d = 128. A layout with more pieces a dim than the
// largest register instantiation (or more than 4 x THREADS dims) runs the
// same kernel with MAXP = 0, which reads the plan from shared memory. The grid
// holds as many blocks as fit the card at once; each block strides over
// tiles of R rows (R a multiple of 16, so every tile starts 16-byte aligned
// whatever the row width), copying the next tile's segments into shared
// memory with 16-byte cp.async while it extracts the current one (two
// buffers). The row loop has no division. Integer arithmetic only: the
// result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_BYTES = 4096;   // target segment bytes of one row tile
constexpr size_t SMEM_LIMIT = 227 * 1024;  // one H100 block's most

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t piece_mask(int nbits) {
  return nbits >= 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1u);
}

// Copy `nbytes` contiguous bytes from src to buf: 16-byte cp.async where
// `vec` (src 16-byte aligned), byte loads for the rest. Commits one group.
__device__ __forceinline__ void stage_tile(unsigned char* __restrict__ buf,
                                           const unsigned char* __restrict__ src,
                                           int nbytes, bool vec) {
  const int n16 = vec ? nbytes / 16 : 0;
  for (int i = threadIdx.x; i < n16; i += THREADS)
    cp_async16(buf + 16 * i, src + 16 * i);
  for (int i = 16 * n16 + threadIdx.x; i < nbytes; i += THREADS)
    buf[i] = __ldg(src + i);
  cp_async_commit();
}

template <typename SegT>
__device__ __forceinline__ uint32_t word(const unsigned char* row, int seg) {
  return (uint32_t)reinterpret_cast<const SegT*>(row)[seg];
}

template <typename SegT, int MAXP>
__global__ void __launch_bounds__(THREADS) extract_kernel(
    const unsigned char* __restrict__ seg, const int4* __restrict__ pieces,
    const int* __restrict__ dim_start, int32_t* __restrict__ out, long long N,
    int G, int D, int n_pieces, int R, int vec_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = G * (int)sizeof(SegT);
  const int tile_bytes = (R * row_bytes + 15) / 16 * 16;  // buffers 0, 1
  const int DG = (D + 3) / 4;                  // groups of 4 dims a row
  const int GW = min(DG, THREADS);             // groups a pass covers
  const int RP = THREADS / GW;                 // rows a pass covers
  const int g0 = threadIdx.x % GW, r_off = threadIdx.x / GW;
  const bool active = r_off < RP;
  const bool vec_out = D % 4 == 0;

  // The plan: in registers (MAXP > 0, one group a thread, GW = DG) or in
  // shared memory after the two tile buffers (MAXP = 0).
  int p_seg[4][MAXP > 0 ? MAXP : 1], p_rsh[4][MAXP > 0 ? MAXP : 1];
  int p_lsh[4][MAXP > 0 ? MAXP : 1], p_cnt[4];
  uint32_t p_mask[4][MAXP > 0 ? MAXP : 1];
  int4* pc = reinterpret_cast<int4*>(smem + 2 * tile_bytes);
  int* ds = reinterpret_cast<int*>(pc + n_pieces);
  if (MAXP > 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * g0 + u;
      const int a = j < D ? dim_start[j] : 0;
      p_cnt[u] = j < D ? dim_start[j + 1] - a : 0;
#pragma unroll
      for (int k = 0; k < (MAXP > 0 ? MAXP : 1); ++k) {
        const int4 p = k < p_cnt[u] ? pieces[a + k] : make_int4(0, 0, 0, 0);
        p_seg[u][k] = p.x;
        p_rsh[u][k] = p.y;
        p_mask[u][k] = piece_mask(p.z);
        p_lsh[u][k] = p.w;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_pieces; i += THREADS) pc[i] = pieces[i];
    for (int i = threadIdx.x; i <= D; i += THREADS) ds[i] = dim_start[i];
  }

  const long long n_tiles = (N + R - 1) / R;
  auto tile_rows = [&](long long t) {
    return (int)min((long long)R, N - t * R);
  };
  long long tile = blockIdx.x;
  if (tile < n_tiles)
    stage_tile(smem, seg + tile * R * row_bytes, tile_rows(tile) * row_bytes,
               vec_in);
  for (int cur = 0; tile < n_tiles; tile += gridDim.x, cur ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      stage_tile(smem + (cur ^ 1) * tile_bytes, seg + next * R * row_bytes,
                 tile_rows(next) * row_bytes, vec_in);
    else
      cp_async_commit();               // an empty group keeps the count
    cp_async_wait_prev();              // this tile's copies have landed
    __syncthreads();
    const int rows = tile_rows(tile);
    int32_t* dst0 = out + tile * R * (long long)D;
    for (int r = r_off; active && r < rows; r += RP) {
      const unsigned char* w = smem + cur * tile_bytes + r * row_bytes;
      int32_t* dst = dst0 + (long long)r * D;
      if (MAXP > 0) {
        uint32_t c[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          c[u] = 0u;
#pragma unroll
          for (int k = 0; k < (MAXP > 0 ? MAXP : 1); ++k)
            if (k < p_cnt[u])
              c[u] |= ((word<SegT>(w, p_seg[u][k]) >> p_rsh[u][k]) &
                       p_mask[u][k]) << p_lsh[u][k];
        }
        if (vec_out) {
          *reinterpret_cast<int4*>(dst + 4 * g0) =
              make_int4((int)c[0], (int)c[1], (int)c[2], (int)c[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * g0 + u < D) dst[4 * g0 + u] = (int32_t)c[u];
        }
      } else {
        for (int g = g0; g < DG; g += GW) {
          uint32_t c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * g + u;
            if (j >= D) continue;
            for (int q = ds[j]; q < ds[j + 1]; ++q) {
              const int4 p = pc[q];    // (seg, rshift, nbits, lshift)
              c[u] |= ((word<SegT>(w, p.x) >> p.y) & piece_mask(p.z)) << p.w;
            }
          }
          if (vec_out) {
            *reinterpret_cast<int4*>(dst + 4 * g) =
                make_int4((int)c[0], (int)c[1], (int)c[2], (int)c[3]);
          } else {
            for (int u = 0; u < 4; ++u)
              if (4 * g + u < D) dst[4 * g + u] = (int32_t)c[u];
          }
        }
      }
    }
    __syncthreads();                   // buffer cur is free for the tile after
  }
}

// Rows of one tile: a multiple of 16 near TILE_BYTES of segments.
int tile_rows_for(int row_bytes) {
  return std::max(16, TILE_BYTES / std::max(row_bytes, 1) / 16 * 16);
}

size_t smem_bytes(int row_bytes, int R, int D, int n_pieces, bool plan_smem) {
  const size_t tile = ((size_t)R * row_bytes + 15) / 16 * 16;
  return 2 * tile +
         (plan_smem ? (size_t)n_pieces * 16 + (size_t)(D + 1) * 4 : 0);
}

template <typename SegT, int MAXP>
int launch(const void* seg, const void* pieces, const void* dim_start,
           void* out, long long N, int G, int D, int n_pieces, cudaStream_t s) {
  const auto kernel = extract_kernel<SegT, MAXP>;
  const int row_bytes = G * (int)sizeof(SegT);
  const int R = tile_rows_for(row_bytes);
  const size_t smem = smem_bytes(row_bytes, R, D, n_pieces, MAXP == 0);
  if (smem > SMEM_LIMIT) return -2;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (N + R - 1) / R;
  const long long blocks = std::max(1LL, std::min<long long>(
      n_tiles, (long long)sms * std::max(per_sm, 1)));
  const int vec_in = (reinterpret_cast<uintptr_t>(seg) & 15) == 0;
  kernel<<<(unsigned)blocks, THREADS, smem, s>>>(
      static_cast<const unsigned char*>(seg), static_cast<const int4*>(pieces),
      static_cast<const int*>(dim_start), static_cast<int32_t*>(out), N, G, D,
      n_pieces, R, vec_in);
  return (int)cudaGetLastError();
}

// The register instantiation for up to 2 or 3 pieces a dim, else the plan
// in shared memory.
template <typename SegT>
int launch_plan(int max_pieces, const void* seg, const void* pieces,
                const void* dim_start, void* out, long long N, int G, int D,
                int n_pieces, cudaStream_t s) {
  const bool regs = (D + 3) / 4 <= THREADS;
  if (regs && max_pieces <= 2)
    return launch<SegT, 2>(seg, pieces, dim_start, out, N, G, D, n_pieces, s);
  if (regs && max_pieces <= 3)
    return launch<SegT, 3>(seg, pieces, dim_start, out, N, G, D, n_pieces, s);
  return launch<SegT, 0>(seg, pieces, dim_start, out, N, G, D, n_pieces, s);
}

}  // namespace

// seg_bytes is 1, 2 or 4 (S = 8, 16, 32); max_pieces is the most pieces of
// any dim. Launches on `stream`; returns the cudaError_t of the launch
// (0 = success), -1 for an unsupported seg_bytes, -2 when the layout's tile
// and plan exceed one block's shared memory.
extern "C" int extract_launch(const void* seg, const void* pieces,
                              const void* dim_start, void* out, long long N,
                              int G, int D, int n_pieces, int max_pieces,
                              int seg_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg_bytes) {
    case 1:
      return launch_plan<uint8_t>(max_pieces, seg, pieces, dim_start, out, N,
                                  G, D, n_pieces, s);
    case 2:
      return launch_plan<uint16_t>(max_pieces, seg, pieces, dim_start, out, N,
                                   G, D, n_pieces, s);
    case 4:
      return launch_plan<uint32_t>(max_pieces, seg, pieces, dim_start, out, N,
                                   G, D, n_pieces, s);
    default:
      return -1;
  }
}
