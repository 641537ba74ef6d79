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
// Layout. Every operand comes with element strides and needs unit stride
// only over its last dimension (C, B, x, out; da takes any strides), so the
// model passes views of its own tensors: C and B as slices of the (B, S,
// conv channels) stream, da and x with the heads innermost, and an output
// whose (G, L, H, P) storage is already the model's (B, S, H, P) layout.
// With 16-byte aligned rows (N, P and the strides multiples of 4) tiles
// stage with 16-byte cp.async, otherwise with 4-byte cp.async.
//
// What bounds it on an H100: bytes. At the language model's prefill shape
// (G = 64, H = 32, L = 256, N = 128, P = 64) it moves about 287 MB (0.086 ms
// at 3.35 TB/s); its causal work is about 9.2 GFLOP of products (0.056 ms at
// the 3xTF32 rate, a third of the 495 TFLOP/s TF32 peak) and 0.2 GFLOP of
// decay on the f32 cores (0.003 ms).
//
// Design. Both products run on the tensor cores with mma.sync m16n8k8 TF32
// and 3xTF32 error compensation: each f32 operand a splits into
// big = tf32(a) and small = a - big, and
// D += small_a big_b + big_a small_b + big_a big_b in f32, which keeps each
// product within ~1e-6 of f32 (one TF32 pass is ~1e-3 relative). mma.sync and
// not wgmma: the second product's A operand is the decayed score tile, made
// per element in registers, and wgmma's TF32 form reads B only K-major from
// shared memory, which the x tiles (p innermost) are not; 3xTF32 through
// wgmma would also need split copies of every tile in shared memory.
//
// One block of 16 warps owns (g, a tile of T = 64 rows l, a group of HB = 16
// heads, a tile of up to 64 head columns p):
//   * warp w prefix-sums head w's da into shared memory in f64, rounded to
//     f32 once per element (each lane adds its 8 consecutive elements in
//     order, a fixed shuffle tree scans the lanes' totals, 256-element
//     chunks carry in order: each cs[t] is summed in an order that depends
//     on t alone);
//   * the score strip S[l][s] = C[l] . B[s] for all s < l0 + T is formed once
//     for the block's 16 heads and kept in shared memory (C and B stream in
//     chunks of KC state columns through a cp.async double buffer);
//   * then GROUPS = 4 heads at a time: their x tiles stream through a
//     cp.async double buffer, and each warp of a head's 4 accumulates a
//     16-row strip of the 64 x 64 output tile in registers, forming its A
//     fragments as S[l][s] exp(cs_l - cs_s) (each decayed score once) with
//     exp evaluated only where l >= s (the upper triangle's exp would
//     overflow, and inf * 0 is NaN). k-steps and score columns wholly above
//     the diagonal are skipped.
// Shared memory at L = 256: 222 KB, one block (16 warps) per SM; L may not
// exceed 256.
// Blocks of the heaviest l-tiles (the most s-tiles) come first in the grid:
// measured, that balances the SMs better than placing the l-tiles of one
// (g, heads) side by side to share their tiles in L2.
// Sums run in another order than the plain PyTorch version's einsums, hence
// the f32 tolerance between the two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows l of a block, columns s of an s-tile
constexpr int PT = 64;         // head columns p per block
constexpr int HB = 16;         // heads per block, sharing its score strip
constexpr int GROUPS = 4;      // heads at a time per block, 4 warps each
constexpr int KC = 32;         // state columns of C and B per staged chunk
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDK = KC + 4;    // pitch of staged C / B chunks
constexpr int LDX = PT + 4;    // pitch of staged x tiles
constexpr int XTILE = T * LDX; // floats of one staged x tile
constexpr int STAGE_SCORES = 2 * 2 * T * LDK;  // two (C, B) chunk buffers
constexpr int STAGE_X = 2 * GROUPS * XTILE;    // two x tiles per head group
constexpr int STAGE = STAGE_SCORES > STAGE_X ? STAGE_SCORES : STAGE_X;

// Fragment order. In a k-step of 8 columns, the thread with index tig in its
// quad takes columns 2 tig and 2 tig + 1 (PTX's k = tig and tig + 4): a
// product may take its k in any order that A and B share, and this one puts
// a thread's two columns side by side, so it reads them as one 64-bit load.
// The pitches then keep every fragment read free of bank conflicts: A reads
// 8 rows x 2 adjacent columns (pitch = 4 mod 32), B of x reads 2 rows x 8
// columns (pitch = 4 mod 32 as well: rows 2 tig, 2 tig + 1 land 8 banks
// apart).

struct Strides {               // element strides
  long long cg, cl;            // C (G, L, N), unit over N
  long long bg, bl;            // B (G, L, N), unit over N
  long long dg, dh, dl;        // da (G, H, L)
  long long xg, xh, xl;        // x (G, H, L, P), unit over P
  long long og, oh, ol;        // out (G, H, L, P), unit over P
};

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;     // 0 bytes read: the rest zero-filled
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// 3xTF32 split: big keeps a's sign, exponent and top 10 mantissa bits (the
// TF32 bits), small = a - big is exact; the tensor cores read small's top
// TF32 bits. Two instructions, about half of what rounding both halves
// with cvt.rna takes.
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(a) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B in 3xTF32, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t b0b,
                                     uint32_t b0s, uint32_t b1b,
                                     uint32_t b1s) {
  mma(d, as, b0b, b1b);
  mma(d, ab, b0s, b1s);
  mma(d, ab, b0b, b1b);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1) ssd_intra_kernel(
    const float* __restrict__ C, const float* __restrict__ B,
    const float* __restrict__ da, const float* __restrict__ x,
    float* __restrict__ out, const Strides st, int G, int H, int L, int N,
    int P) {
  extern __shared__ __align__(16) float smem[];
  const int n_lt = (L + T - 1) / T;
  const int lpad = n_lt * T;
  const int lds = lpad + 4;            // score strip pitch (= 4 mod 32)
  float* cs = smem;                    // (HB, lpad) prefix sums of da
  float* Ss = cs + HB * lpad;          // (T, lds) score strip S[l][s]
  float* stage = Ss + T * lds;         // C / B chunks, then x tiles

  // Block -> (l-tile, g, head group, p-tile), heaviest l-tiles first.
  const int hg_n = (H + HB - 1) / HB;
  const int pt_n = (P + PT - 1) / PT;
  const long long per_lt = (long long)G * hg_n * pt_n;
  const int lt = n_lt - 1 - (int)(blockIdx.x / per_lt);
  const long long rem = blockIdx.x % per_lt;
  const long long g = rem / (hg_n * pt_n);
  const int h0 = (int)((rem / pt_n) % hg_n) * HB;
  const int p0 = (int)(rem % pt_n) * PT;
  const int l0 = lt * T;
  const int l_end = min(L, l0 + T);
  const int n_st = lt + 1;             // s-tiles 0 .. lt (causal)
  const int n_heads = min(HB, H - h0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int k2 = 2 * tig;              // the thread's fragment columns k2, k2 + 1
  const int wr = (warp & 3) * 16;      // the warp's 16 rows of a tile
  constexpr int W = VEC ? 4 : 1;       // floats per cp.async

  // --- score strip S = C[l-tile] B[0 : l0 + T]^T: loads ------------------
  const int nkc = (N + KC - 1) / KC;
  const int n_it = n_st * nkc;
  const float* Cg = C + g * st.cg;
  const float* Bg = B + g * st.bg;
  auto load_scores = [&](int it, int buf) {
    const int s0 = (it / nkc) * T, n0 = (it % nkc) * KC;
    float* cb = stage + buf * 2 * T * LDK;
    for (int i = threadIdx.x; i < 2 * T * (KC / W); i += THREADS) {
      const int which = i / (T * (KC / W));        // 0: C rows, 1: B rows
      const int j = i % (T * (KC / W));
      const int r = j / (KC / W), k = (j % (KC / W)) * W;
      const int row = (which ? s0 : l0) + r, n = n0 + k;
      const bool ok = row < L && n < N;            // N % 4 == 0 under VEC
      const float* base = which ? Bg : Cg;
      const long long rs = which ? st.bl : st.cl;
      cp_async(cb + which * T * LDK + r * LDK + k,
               ok ? base + row * rs + n : base, ok, 4 * W);
    }
  };
  load_scores(0, 0);                   // in flight during the prefix sums
  cp_async_commit();

  // --- prefix sums of da: warp w scans head w ----------------------------
  // In f64, rounded to f32 once per element, as the plain version's CPU
  // cumsum accumulates: each lane sums its 8 consecutive elements of a
  // 256-element chunk in order, a fixed shuffle tree scans the lanes'
  // totals, and chunks carry in order.
  if (warp < n_heads) {
    const float* d = da + g * st.dg + (long long)(h0 + warp) * st.dh;
    float* c = cs + warp * lpad;
    double carry = 0.0;
    for (int c0 = 0; c0 < l_end; c0 += 256) {
      double v[8];
      double run = 0.0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = c0 + 8 * lane + i;
        run += t < l_end ? (double)d[(long long)t * st.dl] : 0.0;
        v[i] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const double up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      const double base = carry + (lane ? excl : 0.0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = c0 + 8 * lane + i;
        if (t < l_end) c[t] = (float)(base + v[i]);
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }  // cs is next read after the score phase's barriers

  // --- score strip: warp w forms rows wr .. wr + 15, columns wc .. wc + 15
  // of each 64 x 64 tile -------------------------------------------------
  {
    const int wc = (warp >> 2) * 16;
    float acc[2][4];
    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) load_scores(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const int sti = it / nkc, kc = it % nkc;
      // Score columns wholly above the diagonal are never read.
      const bool skip = sti == lt && wc > wr + 15;
      if (kc == 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      if (!skip) {
        const float* cb = stage + (it & 1) * 2 * T * LDK;
        const float* bb = cb + T * LDK;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8) {
          const float2 ca = *reinterpret_cast<const float2*>(
              cb + (wr + gid) * LDK + kk + k2);
          const float2 cb8 = *reinterpret_cast<const float2*>(
              cb + (wr + gid + 8) * LDK + kk + k2);
          uint32_t ab[4], as[4];
          split(ca.x, ab[0], as[0]);
          split(cb8.x, ab[1], as[1]);
          split(ca.y, ab[2], as[2]);
          split(cb8.y, ab[3], as[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float2 bv = *reinterpret_cast<const float2*>(
                bb + (wc + nt * 8 + gid) * LDK + kk + k2);
            uint32_t b0b, b0s, b1b, b1s;
            split(bv.x, b0b, b0s);
            split(bv.y, b1b, b1s);
            mma3(acc[nt], ab, as, b0b, b0s, b1b, b1s);
          }
        }
        if (kc == nkc - 1) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* s0 = Ss + (wr + gid) * lds + sti * T + wc + nt * 8 + k2;
            *reinterpret_cast<float2*>(s0) = make_float2(acc[nt][0],
                                                         acc[nt][1]);
            *reinterpret_cast<float2*>(s0 + 8 * lds) =
                make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
      __syncthreads();                 // buffer it & 1 is free again
    }
  }

  // --- per head: y[l-tile] = sum over s-tiles (S o decay) x[s-tile]. The
  // block takes GROUPS heads at a time; in each, warp w owns rows
  // wr .. wr + 15 and all 64 columns of the head's output tile, so every
  // decayed score is formed once ----------------------------------------
  const float* xg = x + g * st.xg;
  const int n_slots = (n_heads + GROUPS - 1) / GROUPS;
  auto load_x = [&](int i, int buf) {
    const int slot = i / n_st, s0 = (i % n_st) * T;
    for (int j = threadIdx.x; j < GROUPS * T * (PT / W); j += THREADS) {
      const int grp = j / (T * (PT / W));
      const int hh = slot * GROUPS + grp;
      const int r = (j / (PT / W)) % T, c = (j % (PT / W)) * W;
      if (hh >= n_heads) continue;
      const float* xh = xg + (long long)(h0 + hh) * st.xh;
      const bool ok = s0 + r < L && p0 + c < P;    // P % 4 == 0 under VEC
      cp_async(stage + (buf * GROUPS + grp) * XTILE + r * LDX + c,
               ok ? xh + (long long)(s0 + r) * st.xl + p0 + c : xg, ok,
               4 * W);
    }
  };

  const int grp = warp >> 2;
  const int la = l0 + wr + gid, lb = la + 8;     // the thread's rows l
  const float* sra = Ss + (wr + gid) * lds;
  const float* srb = sra + 8 * lds;
  const int n_tiles = n_slots * n_st;
  float acc[8][4];
  float cla = 0.f, clb = 0.f;                    // cs at rows la, lb
  load_x(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int hh = (i / n_st) * GROUPS + grp, sti = i % n_st;
    if (i + 1 < n_tiles) load_x(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (hh < n_heads) {
      const float* csh = cs + hh * lpad;
      if (sti == 0) {
        cla = csh[la];
        clb = csh[lb];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      const float* xb = stage + ((i & 1) * GROUPS + grp) * XTILE;
      const int s_base = sti * T;
      // k-steps wholly above the diagonal add nothing; only the diagonal
      // tile and a ragged last l-tile need the mask
      const bool diag = sti == lt;
      const int k_end = diag ? min(T, wr + 16) : T;
      const bool masked = diag || l0 + T > L;
#pragma unroll
      for (int kk = 0; kk < k_end; kk += 8) {
        const int ga = s_base + kk + k2, gb = ga + 1;  // the columns s
        const float2 csv = *reinterpret_cast<const float2*>(csh + ga);
        const float2 sva = *reinterpret_cast<const float2*>(sra + ga);
        const float2 svb = *reinterpret_cast<const float2*>(srb + ga);
        float m[4];
        if (masked) {
          // exp only where l >= s (then s < L too); select, never
          // multiply, so the upper triangle's values never reach the sum
          m[0] = la >= ga && la < L ? sva.x * expf(cla - csv.x) : 0.f;
          m[1] = lb >= ga && lb < L ? svb.x * expf(clb - csv.x) : 0.f;
          m[2] = la >= gb && la < L ? sva.y * expf(cla - csv.y) : 0.f;
          m[3] = lb >= gb && lb < L ? svb.y * expf(clb - csv.y) : 0.f;
        } else {                                 // every l > s and l < L
          m[0] = sva.x * expf(cla - csv.x);
          m[1] = svb.x * expf(clb - csv.x);
          m[2] = sva.y * expf(cla - csv.y);
          m[3] = svb.y * expf(clb - csv.y);
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(m[e], ab[e], as[e]);
        const float* x0 = xb + (kk + k2) * LDX + gid;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t b0b, b0s, b1b, b1s;
          split(x0[nt * 8], b0b, b0s);
          split(x0[LDX + nt * 8], b1b, b1s);
          mma3(acc[nt], ab, as, b0b, b0s, b1b, b1s);
        }
      }
      if (sti == n_st - 1) {
        float* oh = out + g * st.og + (long long)(h0 + hh) * st.oh;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int l = half ? lb : la;
          if (l >= L) continue;
          float* orow = oh + (long long)l * st.ol;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int p = p0 + nt * 8 + k2;
            if (p < P) orow[p] = acc[nt][2 * half];
            if (p + 1 < P) orow[p + 1] = acc[nt][2 * half + 1];
          }
        }
      }
    }
    __syncthreads();                   // buffer i & 1 is free again
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <bool VEC>
int launch(const float* C, const float* B, const float* da, const float* x,
           float* out, const Strides& st, int G, int H, int L, int N, int P,
           size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ssd_intra_kernel<VEC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((L + T - 1) / T) * G *
                           ((H + HB - 1) / HB) * ((P + PT - 1) / PT);
  ssd_intra_kernel<VEC><<<(unsigned)blocks, THREADS, smem, stream>>>(
      C, B, da, x, out, st, G, H, L, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block uses for chunk length L.
extern "C" long long ssd_intra_smem_bytes(int L) {
  const long long lpad = (long long)((L + T - 1) / T) * T;
  return (HB * lpad + T * (lpad + 4) + STAGE) * (long long)sizeof(float);
}

// `strides` holds 13 element strides: C (g, l), B (g, l), da (g, h, l),
// x (g, h, l), out (g, h, l); the last dimension of C, B, x and out has unit
// stride. Launches on `stream`; returns the cudaError_t of the launch
// (0 = success).
extern "C" int ssd_intra_launch(const void* C, const void* B, const void* da,
                                const void* x, void* out,
                                const long long* strides, int G, int H, int L,
                                int N, int P, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11],
                   strides[12]};
  const bool vec = aligned16(C) && aligned16(B) && aligned16(x) &&
                   N % 4 == 0 && P % 4 == 0 && st.cg % 4 == 0 &&
                   st.cl % 4 == 0 && st.bg % 4 == 0 && st.bl % 4 == 0 &&
                   st.xg % 4 == 0 && st.xh % 4 == 0 && st.xl % 4 == 0;
  const size_t smem = (size_t)ssd_intra_smem_bytes(L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(C);
  const float* b = static_cast<const float*>(B);
  const float* d = static_cast<const float*>(da);
  const float* xv = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  return vec ? launch<true>(c, b, d, xv, o, st, G, H, L, N, P, smem, s)
             : launch<false>(c, b, d, xv, o, st, G, H, L, N, P, smem, s);
}
