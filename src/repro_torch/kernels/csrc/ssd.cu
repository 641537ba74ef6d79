// Mamba2 SSD intra-chunk term for the language model's prefill (kernel 6).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd.py::ssd_intra_block (body
// ssd_intra_kernel):
//   C, B (G, L, N) f32, da (G, H, L) f32, x (G, H, L, P) f32 -> (G, H, L, P)
//   y[g, h, l] = sum_{s <= l} exp(cs[g, h, l] - cs[g, h, s]) (C[g, l] . B[g, s])
//                x[g, h, s],   cs = cumsum(da) over the chunk,
// i.e. (tril(exp(segsum(da))) o (C B^T)) x per (batch-chunk g, head h), with
// g = batch * chunk, L the chunk length and N, P the state and head widths.
// C and B are shared by all heads (n_groups = 1).
//
// What bounds it on an H100: operations. At the language model's prefill
// shape (G = 64, H = 32, L = 256, N = 128, P = 64) the causal work is about
// 9 GFLOP against about 290 MB moved, so f32 arithmetic, not device memory,
// sets the floor.
//
// Design. The Pallas kernel keeps a whole L x L block in VMEM; at L = 256 an
// f32 block is 256 KB, more than a block's 227 KB of shared memory. Here one
// thread block owns (g, a tile of T = 64 rows l, a group of HB = 4 heads, a
// tile of up to 64 head columns p) and streams the s-tiles with s0 <= l0 only
// (causal: the upper triangle is never touched):
//   * the block first prefix-sums da of its heads into shared memory, one
//     thread per head in a fixed sequential order;
//   * per s-tile it forms the 64 x 64 score tile C[l-tile] B[s-tile]^T over N
//     in chunks of NK state columns, once for all HB heads (the Pallas grid
//     recomputes it per head);
//   * per head it multiplies the score tile by the decay tile, with exp
//     evaluated only where l >= s (exp of the positive upper-triangle
//     differences overflows, and inf * 0 would give NaN), and accumulates
//     (decayed scores) x[s-tile] into a 64 x 64 register tile per head.
// 256 threads each own a 4 x 4 micro-tile (rows ty + 16 i, columns tx + 16 j)
// of the score tile and of every head's output tile. f32 CUDA cores only;
// sums run in another order than the plain PyTorch version's einsums, hence
// the f32 tolerance between the two.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;          // rows l and columns s of a tile
constexpr int NK = 16;         // state columns of C and B staged per step
constexpr int HB = 4;          // heads per block, sharing each score tile
constexpr int PT = 64;         // head columns p per block
constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int LD = T + 1;      // padded row of the transposed tiles

__global__ void __launch_bounds__(THREADS) ssd_intra_kernel(
    const float* __restrict__ C, const float* __restrict__ B,
    const float* __restrict__ da, const float* __restrict__ x,
    float* __restrict__ out, int H, int L, int N, int P, int head_groups) {
  extern __shared__ float smem[];
  float* cs = smem;                // (HB, L) prefix sums of da
  float* Cs = cs + HB * L;         // (NK, LD) C[l-tile, k-chunk], transposed
  float* Bs = Cs + NK * LD;        // (NK, LD) B[s-tile, k-chunk], transposed
  float* Ms = Bs + NK * LD;        // (T, LD) decayed scores, Ms[s][l]
  float* Xs = Ms + T * LD;         // (T, PT) x[h, s-tile, p-tile]

  const long long g = blockIdx.x;
  const int l0 = blockIdx.y * T;
  const int h0 = (blockIdx.z % head_groups) * HB;
  const int p0 = (blockIdx.z / head_groups) * PT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int l_end = min(L, l0 + T);

  if (threadIdx.x < HB && h0 + threadIdx.x < H) {
    const float* d = da + (g * H + h0 + threadIdx.x) * L;
    float* c = cs + threadIdx.x * L;
    float run = 0.f;
    for (int t = 0; t < l_end; ++t) {
      run = __fadd_rn(run, d[t]);
      c[t] = run;
    }
  }

  float acc[HB][4][4];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hh][i][j] = 0.f;

  for (int s0 = 0; s0 <= l0; s0 += T) {
    // Score tile S[l][s] = C[l] . B[s] over N.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int k0 = 0; k0 < N; k0 += NK) {
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < T * NK; i += THREADS) {
        const int r = i / NK;
        const int k = i - r * NK;
        const int n = k0 + k;
        float cv = 0.f, bv = 0.f;
        if (n < N) {
          if (l0 + r < L) cv = C[(g * L + l0 + r) * N + n];
          if (s0 + r < L) bv = B[(g * L + s0 + r) * N + n];
        }
        Cs[k * LD + r] = cv;
        Bs[k * LD + r] = bv;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[k * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
      }
    }

    // Per head: decay the scores, then accumulate them times x[s-tile].
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const int h = h0 + hh;
      if (h < H) {  // the same for every thread of the block
        __syncthreads();  // Ms and Xs are free; cs is written
        const float* c = cs + hh * L;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float m = 0.f;
            if (l >= s && l < L) m = sc[i][j] * expf(c[l] - c[s]);
            Ms[(tx + 16 * j) * LD + ty + 16 * i] = m;
          }
        }
        const float* xh = x + (g * H + h) * (long long)L * P;
        for (int i = threadIdx.x; i < T * PT; i += THREADS) {
          const int r = i / PT;
          const int col = i - r * PT;
          float v = 0.f;
          if (s0 + r < L && p0 + col < P)
            v = xh[(long long)(s0 + r) * P + p0 + col];
          Xs[r * PT + col] = v;
        }
        __syncthreads();
        for (int s = 0; s < T; ++s) {
          float m[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = Ms[s * LD + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[s * PT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[hh][i][j] = fmaf(m[i], xv[j], acc[hh][i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const int h = h0 + hh;
    if (h >= H) continue;
    float* oh = out + (g * H + h) * (long long)L * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx + 16 * j;
        if (l < L && p < P) oh[(long long)l * P + p] = acc[hh][i][j];
      }
    }
  }
}

}  // namespace

// Shared memory one block uses for chunk length L.
extern "C" long long ssd_intra_smem_bytes(int L) {
  return (long long)(HB * L + 2 * NK * LD + T * LD + T * PT) * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int ssd_intra_launch(const void* C, const void* B, const void* da,
                                const void* x, void* out, int G, int H, int L,
                                int N, int P, void* stream) {
  const int head_groups = (H + HB - 1) / HB;
  const int p_tiles = (P + PT - 1) / PT;
  const dim3 grid((unsigned)G, (unsigned)((L + T - 1) / T),
                  (unsigned)(head_groups * p_tiles));
  const size_t smem = (size_t)ssd_intra_smem_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_intra_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(da), static_cast<const float*>(x),
      static_cast<float*>(out), H, L, N, P, head_groups);
  return (int)cudaGetLastError();
}
