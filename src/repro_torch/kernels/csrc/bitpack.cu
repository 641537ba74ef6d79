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
// first piece, and every block copies the table into shared memory. Nothing
// is generated at run time; one build serves every layout.
//
// What bounds it on an H100: bytes. Each row reads G * S / 8 bytes and
// writes 4 d bytes (at the index's shapes, G = 64 one-byte segments and
// d = 128: 64 bytes in, 512 out), against a few integer operations per piece.
//
// Design: one block per tile of R rows. The block stages the tile's segments
// in shared memory (one coalesced pass over R * G contiguous words, widened to
// 32 bits), then one thread per (row, dim), dims innermost, walks the dim's
// pieces and writes its code, so neighbouring threads write neighbouring
// words of the output. Integer arithmetic only: the result equals the plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename SegT>
__global__ void __launch_bounds__(THREADS) extract_kernel(
    const SegT* __restrict__ seg, const int4* __restrict__ pieces,
    const int* __restrict__ dim_start, int32_t* __restrict__ out, long long N,
    int G, int D, int n_pieces, int R) {
  extern __shared__ int4 smem4[];
  int4* pc = smem4;                                   // (n_pieces,)
  int* ds = reinterpret_cast<int*>(pc + n_pieces);    // (D + 1,)
  uint32_t* words = reinterpret_cast<uint32_t*>(ds + D + 1);  // (R, G)

  for (int i = threadIdx.x; i < n_pieces; i += THREADS) pc[i] = pieces[i];
  for (int i = threadIdx.x; i <= D; i += THREADS) ds[i] = dim_start[i];
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, N - row0);
  const SegT* src = seg + row0 * G;
  for (int i = threadIdx.x; i < rows * G; i += THREADS)
    words[i] = (uint32_t)src[i];
  __syncthreads();

  int32_t* dst = out + row0 * D;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D;
    const int j = i - r * D;
    const uint32_t* w = words + r * G;
    uint32_t code = 0u;
    for (int q = ds[j]; q < ds[j + 1]; ++q) {
      const int4 p = pc[q];  // (seg, rshift, nbits, lshift)
      const uint32_t mask = p.z >= 32 ? 0xFFFFFFFFu : ((1u << p.z) - 1u);
      code |= ((w[p.x] >> p.y) & mask) << p.w;
    }
    dst[i] = (int32_t)code;
  }
}

template <typename SegT>
int launch(const void* seg, const void* pieces, const void* dim_start,
           void* out, long long N, int G, int D, int n_pieces, int R,
           size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        extract_kernel<SegT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  extract_kernel<SegT><<<blocks, THREADS, smem, s>>>(
      static_cast<const SegT*>(seg), static_cast<const int4*>(pieces),
      static_cast<const int*>(dim_start), static_cast<int32_t*>(out), N, G, D,
      n_pieces, R);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one block: the plan plus R rows of G widened words.
extern "C" long long extract_smem_bytes(int G, int D, int n_pieces, int R) {
  return (long long)n_pieces * 16 + (long long)(D + 1) * 4 +
         (long long)R * G * 4;
}

// seg_bytes is 1, 2 or 4 (S = 8, 16, 32). Launches on `stream`; returns the
// cudaError_t of the launch (0 = success, -1 = unsupported seg_bytes).
extern "C" int extract_launch(const void* seg, const void* pieces,
                              const void* dim_start, void* out, long long N,
                              int G, int D, int n_pieces, int R, int seg_bytes,
                              void* stream) {
  const size_t smem = (size_t)extract_smem_bytes(G, D, n_pieces, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg_bytes) {
    case 1:
      return launch<uint8_t>(seg, pieces, dim_start, out, N, G, D, n_pieces, R,
                             smem, s);
    case 2:
      return launch<uint16_t>(seg, pieces, dim_start, out, N, G, D, n_pieces,
                              R, smem, s);
    case 4:
      return launch<uint32_t>(seg, pieces, dim_start, out, N, G, D, n_pieces,
                              R, smem, s);
    default:
      return -1;
  }
}
