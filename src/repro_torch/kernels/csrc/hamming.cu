// Packed binary Hamming distances for the batched query plane (Stage 3).
//
// Replaces the TPU Pallas kernel repro/kernels/hamming.py::packed_hamming_stacked
// (body hamming_stacked_kernel): (Q, P, G) packed query words against
// (P, N, G) stacked partition rows -> (Q, P, N) int32 XOR-popcount distances.
// The single-query view packed_hamming (hamming.py:45) is this kernel at
// Q = P = 1.
//
// What bounds it on an H100: bytes. Per (query, partition, row) the work is G
// XORs, G popcounts and G adds, but every distance is written out as 4 bytes:
// at the plane's shapes (Q=64, P=10, N=105,000, G=4) the output is ~269 MB
// against ~17 MB of packed rows, so the kernel is a write stream.
//
// Design: one thread block per (row tile of BN rows, partition, query tile of
// BQ queries). The tile's (BQ, G) query words sit in shared memory; each thread
// owns one row, loads its G words once (one 16-byte load per 4 words when the
// row is 16-byte aligned) and keeps BQ running sums in registers, so each row
// word is read from device memory once per query tile instead of once per
// query. Writes are coalesced: neighbouring threads write neighbouring rows of
// the same (query, partition) output row. Integer sums are exact, so the
// result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 256;  // rows per block, one per thread
constexpr int BQ = 16;   // queries per block

template <bool VEC>
__global__ void __launch_bounds__(BN) hamming_stacked_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
    int32_t* __restrict__ out, int Q, int P, long long N, int G) {
  extern __shared__ uint32_t qs[];  // (BQ, G) query words of this tile
  const int p = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int nq = min(BQ, Q - q0);
  for (int i = threadIdx.x; i < BQ * G; i += BN) {
    const int qi = i / G;
    const int g = i - qi * G;
    qs[i] = qi < nq ? q[((long long)(q0 + qi) * P + p) * G + g] : 0u;
  }
  __syncthreads();
  const long long n = (long long)blockIdx.x * BN + threadIdx.x;
  if (n >= N) return;
  const uint32_t* row = db + ((long long)p * N + n) * G;

  int acc[BQ];
#pragma unroll
  for (int i = 0; i < BQ; ++i) acc[i] = 0;
  if (VEC) {
    for (int g = 0; g < G; g += 4) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + g));
#pragma unroll
      for (int i = 0; i < BQ; ++i) {
        const uint32_t* qw = qs + i * G + g;
        acc[i] += __popc(w.x ^ qw[0]) + __popc(w.y ^ qw[1]) +
                  __popc(w.z ^ qw[2]) + __popc(w.w ^ qw[3]);
      }
    }
  } else {
    for (int g = 0; g < G; ++g) {
      const uint32_t w = __ldg(row + g);
#pragma unroll
      for (int i = 0; i < BQ; ++i) acc[i] += __popc(w ^ qs[i * G + g]);
    }
  }
#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    if (i < nq) out[((long long)(q0 + i) * P + p) * N + n] = acc[i];
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int hamming_stacked_launch(const void* q, const void* db, void* out,
                                      int Q, int P, long long N, int G,
                                      void* stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)P,
                  (unsigned)((Q + BQ - 1) / BQ));
  const size_t smem = (size_t)BQ * G * sizeof(uint32_t);
  const bool vec = (G % 4 == 0) && ((reinterpret_cast<uintptr_t>(db) & 15) == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    hamming_stacked_kernel<true><<<grid, BN, smem, s>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
        static_cast<int32_t*>(out), Q, P, N, G);
  } else {
    hamming_stacked_kernel<false><<<grid, BN, smem, s>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
        static_cast<int32_t*>(out), Q, P, N, G);
  }
  return (int)cudaGetLastError();
}
