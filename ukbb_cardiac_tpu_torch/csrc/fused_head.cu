// Fused FCN multiscale head for inference, hand-written for Hopper (sm_90a),
// every product on the tensor cores.
//
// Replaces the Pallas TPU kernel ukbb_cardiac_tpu/models/pallas_head.py:178
// (`_run`, body `_make_kernel`).
// Same function as
// ukbb_cardiac_tpu_torch/models/fused_head.py::fused_head_plain: per pixel,
//   h_0   = relu(f_0 . Wsd_0 + bsd_0)                       level 0, full size
//   h_l   = bilinear x2^l of relu(f_l . Wsd_l + bsd_l)      levels 1..L-1
//   z1    = relu(sum_l h_l . W1[l] + b1)                    fc1, BN folded
//   z2    = relu(z1 . W2 + b2)                              fc2, BN folded
//   out   = z2 . Wout + bout                                channels-first f32
// Features are NCHW float32 or bfloat16; weights and accumulation float32.
//
// The bilinear upsample is linear over space and fc1 is linear over
// channels, so the two commute: h_l . W1[l] equals the bilinear upsample of
// relu(f_l . Wsd_l + bsd_l) . W1[l].  Each coarse level's slice of fc1 runs
// at the coarse resolution (1/4^l of the pixels) and the full-resolution
// pass interpolates 64-channel partial sums, which takes fc1's
// full-resolution work from 160x64 to 32x64 MACs per pixel.
//
// Bound on this card, at the main path's chunk (N, X, Y) = (64, 192, 208)
// with channels (16, 32, 64, 128, 256), same_dim 32, fc 64, 4 classes:
//   operations per output pixel: level-0 projection 2*16*32 = 1024, its fc1
//   slice 2*32*64 = 4096, fc2 2*64*64 = 8192, out 2*64*4 = 512 (the kernel
//   computes 8 columns), the coarse levels' 2*(C_l*32 + 32*64)/4^l summed
//   over l = 1..4 = 2320; bilinear taps 2*4*4*64 = 2048 on the CUDA cores.
//   In all 46.5 GFLOP: 0.69 ms as float32 on the CUDA cores (67 TFLOP/s).
//   On the tensor cores each product costs three TF32 products (below):
//   3 x 41.3 GFLOP at 495 TFLOP/s (TF32 dense) = 0.250 ms, beside which the
//   taps' 5.2 GFLOP take 0.078 ms on the CUDA cores.
//   bytes: float32 features in 317 MB, logits out 41 MB: 358 MB at
//   3.35 TB/s -> 0.11 ms, plus the coarse scratch (217 MB written, read
//   back through L2/L1).  So the bound is the tensor cores', 0.250 ms.
//
// Why 3xTF32.  A TF32 operand keeps 10 mantissa bits.  Rounding every
// operand of the head's products once (single TF32) puts the logits of the
// trained FCN_sa head up to 1.1e-2 from a float64 reference on phantom
// slices, a hundred times the 1e-4 bound against the float32 plain version.
// Splitting each operand x into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// and summing a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the lo.lo term is below
// float32's last bit) gave 3.6e-6, as exact as the float32 plain version
// itself (4.9e-6).  The weights are split once on the host
// (HeadWeights.packed); activations are split in registers.  bfloat16
// features fit in TF32, so their lo part is zero and the first product
// skips it.  The hi.hi products and the two correction products go to
// separate accumulators, summed when the product is done, so that no mma
// waits on the one before it.
//
// Fragments.  mma.sync.aligned.m16n8k8 TF32, lane = 4*g + t:
//   A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8):  b0 (t, g), b1 (t+4, g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The weights are stored in the order the B fragments are read: per
// (k-block, n-block), per lane, float4 {hi b0, hi b1, lo b0, lo b1}, one
// 16-byte shared-memory load for three mma.  The products chain on chip
// with no shuffle: a C fragment's n-block, after bias and ReLU, is the next
// product's A fragment for the same k-block if A column t holds C column 2t
// and A column t+4 holds C column 2t+1.  So the host permutes the next
// weight's rows within each block of 8 (row t <- 2t, row t+4 <- 2t+1), and
// a0 = c0, a1 = c2, a2 = c1, a3 = c3.  The level-0 and coarse projections
// read their A fragments from staged features, in channel order.
//
// Kernels, on the caller's stream:
//   coarse_kernel<level>: one launch per coarse level, one block of 4 warps
//     per tile of 64 pixels of one image (16 per warp).  The feature tile
//     is staged 32 channels at a time with cp.async, double-buffered over
//     the channel chunks; the projection runs chunk by chunk, then the fc1
//     slice, and the 64 partial sums per pixel go to a float32 scratch,
//     channels-last (N, X_l, Y_l, 64), so a bilinear tap is two 128-byte
//     lines.
//   head_kernel: a persistent grid of one wave (3 blocks of 4 warps per SM);
//     block b walks tiles b, b + grid, ... of 128 consecutive pixels of one
//     image, so neighbouring SMs read the same coarse rows at the same time.
//     The tile's C0 x 128 features are copied into shared memory with
//     cp.async, double-buffered, so the next tile loads while this one runs
//     its mma; each warp takes 16-pixel blocks of it: level-0 projection ->
//     fc1 slice (accumulators in registers) -> the coarse levels' bilinear
//     taps added on the CUDA cores -> fc2, two n-blocks at a time, each
//     feeding the output product at once.  Only features come in and only
//     logits go out.
//   Shared-memory rows of a staged tile are padded by 8 elements, so the A
//   fragment loads hit 32 distinct banks.  Pixels past the end of an image
//   are staged as zeros and never stored; an image whose plane or pointer
//   is not 16-byte aligned is staged with plain loads instead of cp.async.
// Registers (nvcc 12.8, -Xptxas -v): head_kernel 136 (float) / 138
// (bfloat16), coarse_kernel 128 / 128, no spills.  Measured on the H100
// (PERF.md section 6): head_kernel takes 1.15 ms at (64, 192, 208) f32,
// where its products' 3xTF32 bound is 0.21 ms; tiles of 8 warps, one
// 12-warp block per SM, contiguous tile ranges per block, float4 tap loads
// and skipping zero-weight taps were each slower.
// The C entry point returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int SD = 32;        // same_dim
constexpr int FC = 64;        // fc width
constexpr int NCP = 8;        // class axis padded to one n-block
constexpr int MAX_LEVEL = 5;
constexpr int THREADS = 128;  // head_kernel: 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;     // level-0 pixels per staged tile
constexpr int CTHREADS = 128;  // coarse_kernel: 4 warps
constexpr int CTILE = 16 * (CTHREADS / 32);  // coarse pixels per tile
constexpr int KCHUNK = 32;    // coarse channels per staged chunk
constexpr int PAD = 8;        // shared-memory row padding, elements

struct Args {
  const void* feats[MAX_LEVEL];  // NCHW, level l is (N, C_l, X>>l, Y>>l)
  int chans[MAX_LEVEL];
  bool aligned[MAX_LEVEL];       // 16-byte copies possible for level l
  int n_level, N, X, Y, n_class;
  const float* wbuf;             // packed weights, see HeadWeights.packed
  int head_len;                  // floats of the head block at wbuf[0]
  int w_off[MAX_LEVEL];          // offset of level l's block, l >= 1
  const int2* tap_idx;           // per level l >= 1: X entries, then Y
  const float2* tap_w;
  float* scratch;                // levels l >= 1, (N, X_l, Y_l, FC) each
  size_t scratch_off[MAX_LEVEL];
  float* out;                    // (N, n_class, X, Y)
};

// floats of a (K x N) weight in fragment order: hi and lo of each entry
__host__ __device__ constexpr int frag_len(int K, int N) { return 2 * K * N; }
__host__ __device__ constexpr int pad8(int c) { return (c + 7) & ~7; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a . b in 3xTF32 as two accumulator chains, so that consecutive mma do
// not wait on each other: d += a_hi . b_hi, e += a_lo . b_hi + a_hi . b_lo.
// `frag` is this lane's float4 {hi b0, hi b1, lo b0, lo b1} in shared
// memory.  fold() adds e into d once the product is done.
template <bool A_LO>
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const float* frag) {
  const float4 b = *reinterpret_cast<const float4*>(frag);
  mma(d, ahi, __float_as_uint(b.x), __float_as_uint(b.y));
  if (A_LO) mma(e, alo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma(e, ahi, __float_as_uint(b.z), __float_as_uint(b.w));
}

template <int N>
__device__ __forceinline__ void fold(float (&d)[N][4], const float (&e)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[i][k] += e[i][k];
}

// lane's float4 of fragment (kb, nb) of a weight with NB n-blocks
__device__ __forceinline__ const float* frag_at(const float* W, int NB,
                                                int kb, int nb, int lane) {
  return W + ((kb * NB + nb) * 32 + lane) * 4;
}

// C fragment (n-block columns 8j + 2t, 8j + 2t + 1) plus bias, ReLU ->
// split A fragment of k-block j of the next product (rows permuted on the
// host): a0 = c0, a1 = c2, a2 = c1, a3 = c3.
__device__ __forceinline__ void c_to_a(const float (&c)[4], const float* bias,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float2 b = *reinterpret_cast<const float2*>(bias + 2 * t);
  split(fmaxf(c[0] + b.x, 0.f), hi[0], lo[0]);
  split(fmaxf(c[2] + b.x, 0.f), hi[1], lo[1]);
  split(fmaxf(c[1] + b.y, 0.f), hi[2], lo[2]);
  split(fmaxf(c[3] + b.y, 0.f), hi[3], lo[3]);
}

// A fragment of k-block kb from a staged tile [channel][row] with row
// stride S, rows m0 .. m0+15; channels at or past C read as zero.
template <typename T, bool A_LO>
__device__ __forceinline__ void tile_to_a(const T* F, int S, int C, int kb,
                                          int m0, int g, int t,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const int c0 = kb * 8 + t, c1 = c0 + 4;
  const float v[4] = {
      c0 < C ? to_float(F[c0 * S + m0 + g]) : 0.f,
      c0 < C ? to_float(F[c0 * S + m0 + g + 8]) : 0.f,
      c1 < C ? to_float(F[c1 * S + m0 + g]) : 0.f,
      c1 < C ? to_float(F[c1 * S + m0 + g + 8]) : 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (A_LO) {
      split(v[i], hi[i], lo[i]);
    } else {
      hi[i] = to_tf32(v[i]);  // exact: a bfloat16 fits in TF32
      lo[i] = 0u;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage channels [0, C) of pixels [p0, p0 + TP) of one image (src points
// at its channel 0) into dst [C][TP + PAD]; pixels past `plane` are zeros.
template <typename T, int TP, int NT>
__device__ __forceinline__ void stage(T* dst, const T* src, int C, int plane,
                                      int p0, bool aligned) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int S = TP + PAD;
  const int valid = min(TP, plane - p0);
  if (aligned) {
    constexpr int PER_ROW = TP / VEC;
    for (int i = threadIdx.x; i < C * PER_ROW; i += NT) {
      const int c = i / PER_ROW;
      const int j = (i - c * PER_ROW) * VEC;
      const int n = max(0, min(VEC, valid - j));
      const T* s = n ? src + static_cast<size_t>(c) * plane + p0 + j : src;
      cp_async16(dst + c * S + j, s, n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = threadIdx.x; i < C * TP; i += NT) {
      const int c = i / TP;
      const int j = i - c * TP;
      dst[c * S + j] =
          j < valid ? src[static_cast<size_t>(c) * plane + p0 + j] : zero<T>();
    }
  }
}

template <int NT>
__device__ __forceinline__ void load_weights(float* sm, const float* src,
                                             int len) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < len / 4; i += NT) d4[i] = __ldg(s4 + i);
}

template <typename T>
__global__ void __launch_bounds__(CTHREADS) coarse_kernel(Args a, int l) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int C = a.chans[l];
  const int Kp = pad8(C);
  const int len = frag_len(Kp, SD) + frag_len(SD, FC) + SD;
  load_weights<CTHREADS>(sm, a.wbuf + a.w_off[l], len);
  const float* fWsd = sm;                      // (Kp/8) x 4 fragments
  const float* fW1 = fWsd + frag_len(Kp, SD);  // 4 x 8, rows permuted
  const float* bsd = fW1 + frag_len(SD, FC);
  T* bufs = reinterpret_cast<T*>(sm + len);
  constexpr int S = CTILE + PAD;

  const int Xl = a.X >> l, Yl = a.Y >> l;
  const int plane = Xl * Yl;
  const int tiles = (plane + CTILE - 1) / CTILE;
  const int n = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - n * tiles) * CTILE;
  const T* f = static_cast<const T*>(a.feats[l]) +
               static_cast<size_t>(n) * C * plane;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  constexpr bool A_LO = sizeof(T) == 4;

  const int chunks = (C + KCHUNK - 1) / KCHUNK;
  stage<T, CTILE, CTHREADS>(bufs, f, min(KCHUNK, C), plane, p0, a.aligned[l]);
  cp_async_commit();
  float h[SD / 8][4] = {}, he[SD / 8][4] = {};
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      const int c = (k + 1) * KCHUNK;
      stage<T, CTILE, CTHREADS>(bufs + ((k + 1) & 1) * KCHUNK * S,
                      f + static_cast<size_t>(c) * plane,
                      min(KCHUNK, C - c), plane, p0, a.aligned[l]);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* F = bufs + (k & 1) * KCHUNK * S;
    const int cn = min(KCHUNK, C - k * KCHUNK);
    for (int kb = 0; kb < pad8(cn) / 8; ++kb) {
      uint32_t hi[4], lo[4];
      tile_to_a<T, A_LO>(F, S, cn, kb, m0, g, t, hi, lo);
#pragma unroll
      for (int nb = 0; nb < SD / 8; ++nb)
        mma3<A_LO>(h[nb], he[nb], hi, lo,
                   frag_at(fWsd, SD / 8, k * (KCHUNK / 8) + kb, nb, lane));
    }
    __syncthreads();
  }
  fold(h, he);

  float q[FC / 8][4] = {}, qe[FC / 8][4] = {};
#pragma unroll
  for (int kb = 0; kb < SD / 8; ++kb) {
    uint32_t hi[4], lo[4];
    c_to_a(h[kb], bsd + kb * 8, t, hi, lo);
#pragma unroll
    for (int nb = 0; nb < FC / 8; ++nb)
      mma3<true>(q[nb], qe[nb], hi, lo, frag_at(fW1, FC / 8, kb, nb, lane));
  }
  fold(q, qe);
  float* dst = a.scratch + a.scratch_off[l] +
               (static_cast<size_t>(n) * plane + p0 + m0 + g) * FC + 2 * t;
  const bool row0 = p0 + m0 + g < plane, row1 = p0 + m0 + g + 8 < plane;
#pragma unroll
  for (int nb = 0; nb < FC / 8; ++nb) {
    if (row0)
      *reinterpret_cast<float2*>(dst + nb * 8) = make_float2(q[nb][0], q[nb][1]);
    if (row1)
      *reinterpret_cast<float2*>(dst + 8 * FC + nb * 8) =
          make_float2(q[nb][2], q[nb][3]);
  }
}

// acc rows R (0: pixel g, 1: pixel g+8) += the 4 bilinear taps of level l
// at pixel (x, y) of image n.
template <int R>
__device__ __forceinline__ void add_taps(float (&acc)[FC / 8][4],
                                         const Args& a, int l, int n, int x,
                                         int y, int t) {
  const int Xl = a.X >> l, Yl = a.Y >> l;
  const int tb = (l - 1) * (a.X + a.Y);
  const int2 ix = a.tap_idx[tb + x];
  const float2 wx = a.tap_w[tb + x];
  const int2 iy = a.tap_idx[tb + a.X + y];
  const float2 wy = a.tap_w[tb + a.X + y];
  const float* S = a.scratch + a.scratch_off[l] +
                   static_cast<size_t>(n) * Xl * Yl * FC + 2 * t;
  const int idx[4] = {ix.x * Yl + iy.x, ix.x * Yl + iy.y, ix.y * Yl + iy.x,
                      ix.y * Yl + iy.y};
  const float wt[4] = {wx.x * wy.x, wx.x * wy.y, wx.y * wy.x, wx.y * wy.y};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* s = S + static_cast<size_t>(idx[k]) * FC;
#pragma unroll
    for (int nb = 0; nb < FC / 8; ++nb) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(s + nb * 8));
      acc[nb][2 * R] = fmaf(wt[k], v.x, acc[nb][2 * R]);
      acc[nb][2 * R + 1] = fmaf(wt[k], v.y, acc[nb][2 * R + 1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) head_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  load_weights<THREADS>(sm, a.wbuf, a.head_len);
  const int C0 = a.chans[0];
  const int Kp0 = pad8(C0);
  const float* fW0 = sm;                      // (Kp0/8) x 4
  const float* fW1 = fW0 + frag_len(Kp0, SD);  // 4 x 8, rows permuted
  const float* fW2 = fW1 + frag_len(SD, FC);   // 8 x 8, rows permuted
  const float* fWo = fW2 + frag_len(FC, FC);   // 8 x 1, rows permuted
  const float* b0 = fWo + frag_len(FC, NCP);
  const float* b1 = b0 + SD;
  const float* b2 = b1 + FC;
  const float* bo = b2 + FC;
  T* bufs = reinterpret_cast<T*>(sm + a.head_len);
  constexpr int S = TILE + PAD;
  const int buf_len = C0 * S;

  const int X = a.X, Y = a.Y, plane = X * Y;
  const int tiles = (plane + TILE - 1) / TILE;
  const int total = a.N * tiles;
  const T* f0 = static_cast<const T*>(a.feats[0]);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  constexpr bool A_LO = sizeof(T) == 4;

  int tile = blockIdx.x;
  if (tile < total) {
    const int n = tile / tiles;
    stage<T, TILE, THREADS>(bufs, f0 + static_cast<size_t>(n) * C0 * plane, C0, plane,
                   (tile - n * tiles) * TILE, a.aligned[0]);
  }
  cp_async_commit();
  for (int it = 0; tile < total; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < total) {
      const int nn = next / tiles;
      stage<T, TILE, THREADS>(bufs + ((it + 1) & 1) * buf_len,
                     f0 + static_cast<size_t>(nn) * C0 * plane, C0, plane,
                     (next - nn * tiles) * TILE, a.aligned[0]);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* F = bufs + (it & 1) * buf_len;
    const int n = tile / tiles;
    const int p0 = (tile - n * tiles) * TILE;

    for (int m0 = warp * 16; m0 < TILE && p0 + m0 < plane; m0 += WARPS * 16) {
      // level 0 projection
      float h[SD / 8][4] = {}, he[SD / 8][4] = {};
      for (int kb = 0; kb < Kp0 / 8; ++kb) {
        uint32_t hi[4], lo[4];
        tile_to_a<T, A_LO>(F, S, C0, kb, m0, g, t, hi, lo);
#pragma unroll
        for (int nb = 0; nb < SD / 8; ++nb)
          mma3<A_LO>(h[nb], he[nb], hi, lo, frag_at(fW0, SD / 8, kb, nb, lane));
      }
      fold(h, he);
      // its fc1 slice
      float acc[FC / 8][4] = {}, acce[FC / 8][4] = {};
#pragma unroll
      for (int kb = 0; kb < SD / 8; ++kb) {
        uint32_t hi[4], lo[4];
        c_to_a(h[kb], b0 + kb * 8, t, hi, lo);
#pragma unroll
        for (int nb = 0; nb < FC / 8; ++nb)
          mma3<true>(acc[nb], acce[nb], hi, lo,
                     frag_at(fW1, FC / 8, kb, nb, lane));
      }
      fold(acc, acce);
      // coarse levels: bilinear taps of their fc1 partial sums
      const int P0 = p0 + m0 + g, P1 = P0 + 8;
      const int q0 = min(P0, plane - 1), q1 = min(P1, plane - 1);
      const int x0 = q0 / Y, x1 = q1 / Y;
#pragma unroll 1
      for (int l = 1; l < a.n_level; ++l) {
        add_taps<0>(acc, a, l, n, x0, q0 - x0 * Y, t);
        add_taps<1>(acc, a, l, n, x1, q1 - x1 * Y, t);
      }
      // fc2, streamed two n-blocks at a time into the output product
      uint32_t zh[FC / 8][4], zl[FC / 8][4];
#pragma unroll
      for (int kb = 0; kb < FC / 8; ++kb)
        c_to_a(acc[kb], b1 + kb * 8, t, zh[kb], zl[kb]);
      float o[1][4] = {}, oe[1][4] = {};
#pragma unroll
      for (int nb = 0; nb < FC / 8; nb += 2) {
        float z[2][4] = {}, ze[2][4] = {};
#pragma unroll
        for (int kb = 0; kb < FC / 8; ++kb) {
          mma3<true>(z[0], ze[0], zh[kb], zl[kb],
                     frag_at(fW2, FC / 8, kb, nb, lane));
          mma3<true>(z[1], ze[1], zh[kb], zl[kb],
                     frag_at(fW2, FC / 8, kb, nb + 1, lane));
        }
        fold(z, ze);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi[4], lo[4];
          c_to_a(z[i], b2 + (nb + i) * 8, t, hi, lo);
          mma3<true>(o[0], oe[0], hi, lo, frag_at(fWo, 1, nb + i, 0, lane));
        }
      }
      fold(o, oe);
      // logits, channels-first: classes 2t, 2t+1 of pixels P0, P1
      const float2 bb = *reinterpret_cast<const float2*>(bo + 2 * t);
      float* dst = a.out + static_cast<size_t>(n) * a.n_class * plane;
      const int k0 = 2 * t, k1 = 2 * t + 1;
      if (P0 < plane) {
        if (k0 < a.n_class) dst[static_cast<size_t>(k0) * plane + P0] = o[0][0] + bb.x;
        if (k1 < a.n_class) dst[static_cast<size_t>(k1) * plane + P0] = o[0][1] + bb.y;
      }
      if (P1 < plane) {
        if (k0 < a.n_class) dst[static_cast<size_t>(k0) * plane + P1] = o[0][2] + bb.x;
        if (k1 < a.n_class) dst[static_cast<size_t>(k1) * plane + P1] = o[0][3] + bb.y;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <typename T>
cudaError_t launch(Args& a, cudaStream_t stream) {
  cudaError_t err;
  constexpr size_t E = sizeof(T);
  const auto coarse_smem = [&](int l) {
    return (frag_len(pad8(a.chans[l]), SD) + frag_len(SD, FC) + SD) *
               sizeof(float) +
           2 * KCHUNK * (CTILE + PAD) * E;
  };
  if (a.n_level > 1) {
    size_t max_smem = 0;
    for (int l = 1; l < a.n_level; ++l)
      max_smem = coarse_smem(l) > max_smem ? coarse_smem(l) : max_smem;
    err = cudaFuncSetAttribute(coarse_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(max_smem));
    if (err != cudaSuccess) return err;
    for (int l = 1; l < a.n_level; ++l) {
      const int plane = (a.X >> l) * (a.Y >> l);
      const int grid = a.N * ((plane + CTILE - 1) / CTILE);
      coarse_kernel<T><<<grid, CTHREADS, coarse_smem(l), stream>>>(a, l);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const size_t smem = static_cast<size_t>(a.head_len) * sizeof(float) +
                      2 * static_cast<size_t>(a.chans[0]) * (TILE + PAD) * E;
  err = cudaFuncSetAttribute(head_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, head_kernel<T>, THREADS, smem)) != cudaSuccess)
    return err;
  const int plane = a.X * a.Y;
  const long long need =
      static_cast<long long>(a.N) * ((plane + TILE - 1) / TILE);
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < wave ? need : wave);
  head_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ukbb_fused_head(int bf16, int n_level, int N, int X, int Y,
                               int n_class, const void* f0, const void* f1,
                               const void* f2, const void* f3, const void* f4,
                               int c0, int c1, int c2, int c3, int c4,
                               const float* wbuf, const int* tap_idx,
                               const float* tap_w, float* scratch, float* out,
                               void* stream) {
  if (n_level < 1 || n_level > MAX_LEVEL || n_class < 1 || n_class > NCP ||
      N < 1 || X < 1 || Y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  const void* feats[MAX_LEVEL] = {f0, f1, f2, f3, f4};
  const int chans[MAX_LEVEL] = {c0, c1, c2, c3, c4};
  const int vec = bf16 ? 8 : 4;  // elements per 16-byte copy
  for (int l = 0; l < MAX_LEVEL; ++l) {
    a.feats[l] = feats[l];
    a.chans[l] = chans[l];
    a.aligned[l] = reinterpret_cast<uintptr_t>(feats[l]) % 16 == 0 &&
                   ((X >> l) * (Y >> l)) % vec == 0;
  }
  a.n_level = n_level;
  a.N = N;
  a.X = X;
  a.Y = Y;
  a.n_class = n_class;
  a.wbuf = wbuf;
  // head block: fragments of Wsd_0, W1 rows of level 0, W2, Wout; then
  // bsd_0, b1, b2, bout
  a.head_len = frag_len(pad8(c0), SD) + frag_len(SD, FC) + frag_len(FC, FC) +
               frag_len(FC, NCP) + SD + FC + FC + NCP;
  int off = a.head_len;
  size_t soff = 0;
  for (int l = 1; l < n_level; ++l) {
    a.w_off[l] = off;  // fragments of Wsd_l, of W1 rows of level l; bsd_l
    off += frag_len(pad8(chans[l]), SD) + frag_len(SD, FC) + SD;
    a.scratch_off[l] = soff;
    soff += static_cast<size_t>(N) * (X >> l) * (Y >> l) * FC;
  }
  a.tap_idx = reinterpret_cast<const int2*>(tap_idx);
  a.tap_w = reinterpret_cast<const float2*>(tap_w);
  a.scratch = scratch;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* ukbb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
