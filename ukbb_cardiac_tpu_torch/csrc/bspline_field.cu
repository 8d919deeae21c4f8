// Cubic B-spline FFD synthesis and its adjoint, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel ukbb_cardiac_tpu/reg/pallas_bspline.py:84
// (`pallas_dense_field`, one (Cx, Cy, 2) lattice per call, forward only).
// Same functions as ukbb_cardiac_tpu_torch/reg/bspline.py::
// bspline_dense_field_plain and ::bspline_adjoint_plain, over a batch:
//
//   forward  (B, Cx, Cy, 2) -> (B, X, Y, 2), spacing s:
//     field[b, x, y, k] = sum_{a,c=0..3} wx[x mod s][a] * wy[y mod s][c]
//                         * C[b, x/s + a, y/s + c, k]
//   adjoint  (B, X, Y, 2) -> (B, Cx, Cy, 2):
//     grad[b, i, j, k] = sum_x sum_y Bx[x, i] By[y, j] G[b, x, y, k]
//
// Bx[x, i] is nonzero only for i = x/s + a, a = 0..3, and depends on x only
// through x mod s, so a (s, 4) table of weights -- built on the host from the
// same float64 cubic B-spline as `basis_matrix`, so it rebuilds that matrix
// exactly -- replaces the dense basis matrices of the Pallas kernel.  Controls
// beyond the lattice the caller passes count as zero: the kernel reads Cx and
// Cy from its arguments, never from the image size (a coarse lattice is
// densified at a finer grid with spacing x ratio, whose lattice may be
// shorter than the one that covers that grid).
//
// Bound on this card at the registration's finest level (B = 150 pairs,
// 96 x 96, 13 x 13 lattice, s = 10): the forward writes 150*96*96*2*4 =
// 11.1 MB and reads 0.2 MB of lattices, 3.4 us at 3.35 TB/s; its FMAs (16
// per column and run of s rows, then 4 per output value) are 26 MFLOP,
// 0.4 us at 67 TFLOP/s.  The adjoint reads the same 11.1 MB.  Both are bound
// by bytes, and at these sizes by launch latency.  The design keeps
// device-memory traffic at the bound: the forward writes each output once,
// 16 bytes per store, and reads the small lattice through the read-only
// cache; the adjoint reads each cotangent byte from device memory once,
// into shared memory.
//
// Two kernels on the caller's stream:
//   field_kernel: a block per pair and band of whole runs of s rows, x =
//     q*s + r (the host plans it, reg/bspline_field.py::field_plan: about
//     20 rows), on a (bands, b) grid with 32-bit index arithmetic; a
//     thread per item, a pair of columns (y, y + 1) and the band's rows of
//     one run q.  The item issues its 20 lattice loads together (control
//     rows q .. q+3 at columns y/s .. y/s+4, zero beyond the lattice: no
//     data-dependent branch holds them back), reduces them over their 4
//     columns for y and for y + 1 in registers (C @ By^T), then writes its
//     s rows with 8 FMAs per pair (Bx @ that) and one 16-byte store of the
//     two neighbouring float2 (two 8-byte stores on a row whose pair is not
//     16-byte aligned, odd Y): a warp writes 512 contiguous bytes a store,
//     with no barrier before its first.  At 96^2: 48 x 2 items per block,
//     96 threads, 750 blocks at B = 150.  The arithmetic is the first
//     design's, in the same order (fmaf over the 4 columns in ascending
//     order, then over the 4 rows, each from zero; a control beyond the
//     lattice, skipped there, is a zero here and adds nothing), so the
//     output is bitwise the same.
//     Tried and slower on the H100 at every strain and propagation shape
//     (PERF.md section 6): the same rows written to a shared tile and out
//     as one bulk asynchronous copy (cp.async.bulk.global.shared::cta),
//     by 2-46 %, and two designs that staged the control rows and their
//     column reductions in shared memory behind barriers.
//   adjoint_kernel: one block of 256 threads per pair, which walks bands of
//     ni x nj controls (the whole lattice unless its partial sums do not
//     fit: the host plans the bands, reg/bspline_field.py::adjoint_plan).
//     A band's support, rows [(i0-3)s, i1*s) by columns [(j0-3)s, j1*s)
//     clipped to the image, is staged through shared memory in slices of up
//     to 256 columns and chunks of whole runs of s rows (40 at s = 10),
//     with cp.async (16-byte copies where aligned), double-buffered: the
//     next chunk loads while this one is summed.
//     Pass 1: one thread per column walks the rows in ascending x; row
//     x = q*s + r feeds controls q .. q+3 with weights w[r][0..3], which
//     the thread keeps as a window of 4 sums in registers, so each staged
//     value is read once; when a run of s rows ends, control q's sum is
//     complete and goes to a shared (ni, W, 2) buffer.
//     Pass 2: threads over (i, j) sum the columns of j's support.
//     Tried and slower on the H100 (PERF.md section 6): 4 threads a
//     column, thread k summing the controls i = k mod 4 in the same order
//     (384 threads, all busy at 96^2), 12.5 us against this design's
//     10.8 us at 96^2: every staged value is then read from shared memory
//     4 times, not once.
//     At 96^2 the band is the whole 13 x 13 lattice and a pair's 73.7 KB
//     cotangent comes in 3 chunks, one block per pair, 72 KB of shared
//     memory (three blocks fit an SM), so the 150 pairs run in one wave; at 192^2 the rows come in
//     10 chunks under one band.  Only where bands are needed (a row of the
//     lattice's partial sums over half of 96 KB) are the 3s rows or columns
//     that two bands share read once per band.  Each control's sums run in
//     ascending x, then ascending y, in fixed loop orders with no atomics:
//     two runs agree bit for bit.
//   Registers (nvcc 12.8, -Xptxas -v): field_kernel 76, adjoint_kernel 48,
//   no spills.
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int FIELD_MAX_THREADS = 256;
constexpr int ADJOINT_THREADS = 256;  // also the widest column slice

// Bx @ (the 4 reductions): fmaf over a = 0..3 from zero, the first
// design's order.
__device__ __forceinline__ float2 combine(float4 wx, const float2* c) {
  float ax = fmaf(wx.x, c[0].x, 0.f), ay = fmaf(wx.x, c[0].y, 0.f);
  ax = fmaf(wx.y, c[1].x, ax);
  ay = fmaf(wx.y, c[1].y, ay);
  ax = fmaf(wx.z, c[2].x, ax);
  ay = fmaf(wx.z, c[2].y, ay);
  ax = fmaf(wx.w, c[3].x, ax);
  ay = fmaf(wx.w, c[3].y, ay);
  return make_float2(ax, ay);
}

// One row's column reduction at one column: sum_k wy[k] C[a][k0 + k] in
// ascending k from zero (the first design's order; a control beyond the
// lattice was skipped there and is a zero here, which adds nothing: the
// sum of +0 and a product of zero is +0).
__device__ __forceinline__ float2 reduce4(float4 wy, const float2* c) {
  float rx = fmaf(wy.x, c[0].x, 0.f), ry = fmaf(wy.x, c[0].y, 0.f);
  rx = fmaf(wy.y, c[1].x, rx);
  ry = fmaf(wy.y, c[1].y, ry);
  rx = fmaf(wy.z, c[2].x, rx);
  ry = fmaf(wy.z, c[2].y, ry);
  rx = fmaf(wy.w, c[3].x, rx);
  ry = fmaf(wy.w, c[3].y, ry);
  return make_float2(rx, ry);
}

__device__ __forceinline__ void store_pair(float2* o, bool two, float2 v0,
                                           float2 v1) {
  if (two && !(reinterpret_cast<uintptr_t>(o) & 15)) {
    *reinterpret_cast<float4*>(o) = make_float4(v0.x, v0.y, v1.x, v1.y);
  } else {
    o[0] = v0;
    if (two) o[1] = v1;
  }
}

__global__ void __launch_bounds__(FIELD_MAX_THREADS)
    field_kernel(int Cx, int Cy, int X, int Y, int s, int rows,
                 const float4* __restrict__ table,
                 const float2* __restrict__ ctl, float2* __restrict__ out) {
  const int b = blockIdx.y;
  const int x0 = blockIdx.x * rows, x1 = min(X, x0 + rows);
  const int q0 = x0 / s, P = (Y + 1) / 2;
  float2* dst = out + (static_cast<size_t>(b) * X + x0) * Y;
  const float2* cb = ctl + static_cast<size_t>(b) * Cx * Cy;
  for (int it = threadIdx.x; it < P * ((x1 - 1) / s - q0 + 1);
       it += blockDim.x) {
    // an item: columns (y, y + 1) and the block's rows of run q
    const int j = it / P, y = 2 * (it - j * P), q = q0 + j;
    const bool two = y + 1 < Y;
    const int qy = y / s, qy1 = (y + 1) / s;
    // the 4 control rows q + a at columns qy .. qy + 4, all loads issued
    // together (zero beyond the lattice)
    float2 c[4][5];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 5; ++k)
        c[a][k] = q + a < Cx && qy + k < Cy
                      ? __ldg(cb + (q + a) * Cy + qy + k)
                      : make_float2(0.f, 0.f);
    const float4 wy0 = __ldg(table + (y - qy * s));
    const float4 wy1 = __ldg(table + (y + 1 - qy1 * s));
    float2 r0[4], r1[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float2 c1[4];  // column y + 1 reads from qy1, one further at a seam
#pragma unroll
      for (int k = 0; k < 4; ++k) c1[k] = qy1 == qy ? c[a][k] : c[a][k + 1];
      r0[a] = reduce4(wy0, c[a]);
      r1[a] = reduce4(wy1, c1);
    }
    const int xa = max(x0, q * s), xb = min(x1, q * s + s);
    for (int x = xa; x < xb; ++x) {
      const float4 wx = __ldg(table + (x - q * s));
      store_pair(dst + (x - x0) * Y + y, two, combine(wx, r0),
                 combine(wx, r1));
    }
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// Stage rows [x0, x1) by columns [ys, ys + ws) of one pair's cotangent
// into dst (x1 - x0, ws), as one cp.async group.
__device__ __forceinline__ void stage_rows(float2* dst, const float2* gb,
                                           int x0, int x1, int ys, int ws,
                                           int Y, bool wide) {
  if (wide) {  // 16-byte copies: Y, ys and ws even, g 16-byte aligned
    const int half = ws / 2;
    for (int k = threadIdx.x; k < (x1 - x0) * half; k += ADJOINT_THREADS) {
      const int r = k / half, c = 2 * (k - r * half);
      cp_async16(dst + r * ws + c, gb + static_cast<size_t>(x0 + r) * Y + ys + c);
    }
  } else {
    for (int k = threadIdx.x; k < (x1 - x0) * ws; k += ADJOINT_THREADS) {
      const int r = k / ws, c = k - r * ws;
      cp_async8(dst + r * ws + c, gb + static_cast<size_t>(x0 + r) * Y + ys + c);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void fma2(float wt, float2 v, float2& acc) {
  acc.x = fmaf(wt, v.x, acc.x);
  acc.y = fmaf(wt, v.y, acc.y);
}

__global__ void __launch_bounds__(ADJOINT_THREADS)
    adjoint_kernel(int Cx, int Cy, int X, int Y, int s, int ni, int nj,
                   int R, int Wmax, const float* __restrict__ table,
                   const float2* __restrict__ g, float2* __restrict__ out) {
  extern __shared__ float4 sm4[];
  const float4* w4 = sm4;                                  // (s) x 4 weights
  const int SW = min(Wmax, ADJOINT_THREADS);               // slice columns
  const int BS = (R * SW + 1) & ~1;                        // float2, even
  float2* stage = reinterpret_cast<float2*>(sm4 + s);      // 2 x (R, SW)
  float2* part = stage + 2 * BS;                           // (ni, Wmax)
  const int tid = threadIdx.x;
  for (int k = tid; k < 4 * s; k += ADJOINT_THREADS)
    reinterpret_cast<float*>(sm4)[k] = table[k];
  const float2* gb = g + static_cast<size_t>(blockIdx.x) * X * Y;
  const bool g16 = reinterpret_cast<uintptr_t>(g) % 16 == 0 && Y % 2 == 0;
  for (int j0 = 0; j0 < Cy; j0 += nj) {
    const int j1 = min(Cy, j0 + nj);
    // columns of the band's support: y with By[y, j] != 0, j0 <= j < j1
    const int ya = max(0, (j0 - 3) * s), W = max(0, min(Y, j1 * s) - ya);
    for (int i0 = 0; i0 < Cx; i0 += ni) {
      const int i1 = min(Cx, i0 + ni), nI = i1 - i0;
      const int xa = max(0, (i0 - 3) * s), xb = min(X, i1 * s);
      const int chunks = xb > xa ? (xb - xa + R - 1) / R : 0;
      __syncthreads();  // the last band's pass 2 is done with part
      for (int k = tid; k < nI * W; k += ADJOINT_THREADS)
        part[k] = make_float2(0.f, 0.f);
      // pass 1, a slice of up to SW columns at a time, one column per
      // thread: walk the rows x in ascending order through the staged
      // chunks; row x = q*s + r feeds controls q .. q+3 with weights
      // w[r][0..3], which the thread keeps as a window of 4 sums in
      // registers.  When a run of s rows ends, control q is complete.
      for (int ys = ya; ys < ya + W; ys += SW) {
        const int ws = min(SW, ya + W - ys);
        const bool wide = g16 && ys % 2 == 0 && ws % 2 == 0;
        float2* col = part + ys - ya + tid;
        float2 c0 = make_float2(0.f, 0.f), c1 = c0, c2 = c0, c3 = c0;
        int q = xa / s, r = 0;
        __syncthreads();  // the stage buffers are free, part is zeroed
        if (chunks)
          stage_rows(stage, gb, xa, min(xb, xa + R), ys, ws, Y, wide);
        for (int c = 0; c < chunks; ++c) {
          const int x0 = xa + c * R, x1 = min(xb, x0 + R);
          if (c + 1 < chunks)
            stage_rows(stage + ((c + 1) & 1) * BS, gb, x1, min(xb, x1 + R),
                       ys, ws, Y, wide);
          else
            asm volatile("cp.async.commit_group;" ::: "memory");
          asm volatile("cp.async.wait_group 1;" ::: "memory");
          __syncthreads();
          if (tid < ws) {
            const float2* v = stage + (c & 1) * BS + tid;
            for (int x = x0; x < x1;) {
              if (r == 0 && x + s <= x1) {  // a whole run: loads in flight
#pragma unroll 4
                for (int k = 0; k < s; ++k) {
                  const float4 wr = w4[k];
                  const float2 gv = v[(x - x0 + k) * ws];
                  fma2(wr.x, gv, c0);
                  fma2(wr.y, gv, c1);
                  fma2(wr.z, gv, c2);
                  fma2(wr.w, gv, c3);
                }
                x += s;
                r = s;
              } else {  // a run cut by the chunk or the image
                const float4 wr = w4[r];
                const float2 gv = v[(x - x0) * ws];
                fma2(wr.x, gv, c0);
                fma2(wr.y, gv, c1);
                fma2(wr.z, gv, c2);
                fma2(wr.w, gv, c3);
                ++x;
                ++r;
              }
              if (r == s) {
                if (q >= i0 && q < i1) col[(q - i0) * W] = c0;
                c0 = c1;
                c1 = c2;
                c2 = c3;
                c3 = make_float2(0.f, 0.f);
                r = 0;
                ++q;
              }
            }
          }
          __syncthreads();  // buffer (c & 1) is free for chunk c + 2
        }
        if (tid < ws) {  // the image ended: the window's sums are complete
          const float2 rest[4] = {c0, c1, c2, c3};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (q + k >= i0 && q + k < i1) col[(q + k - i0) * W] = rest[k];
        }
      }
      __syncthreads();
      // pass 2: each (i, j) of the band sums the columns of j's support
      const int nJ = j1 - j0;
      const float* w = reinterpret_cast<const float*>(sm4);
      for (int k = tid; k < nI * nJ; k += ADJOINT_THREADS) {
        const int il = k / nJ, j = j0 + k - il * nJ;
        const float2* pr = part + il * W;
        float ax = 0.f, ay = 0.f;
        for (int a = 3; a >= 0; --a) {
          const int y0 = (j - a) * s;
          const int r0 = max(0, -y0), r1 = min(s, Y - y0);
#pragma unroll 4
          for (int r = r0; r < r1; ++r) {
            const float wt = w[r * 4 + a];
            const float2 v = pr[y0 + r - ya];
            ax = fmaf(wt, v.x, ax);
            ay = fmaf(wt, v.y, ay);
          }
        }
        out[(static_cast<size_t>(blockIdx.x) * Cx + i0 + il) * Cy + j] =
            make_float2(ax, ay);
      }
    }
  }
}

bool bad_shape(int B, int Cx, int Cy, int X, int Y, int s) {
  return B < 1 || Cx < 1 || Cy < 1 || X < 1 || Y < 1 || s < 1;
}

}  // namespace

extern "C" int ukbb_bspline_field(int B, int Cx, int Cy, int X, int Y, int s,
                                  int rows, int threads, const float* table,
                                  const float* control, float* field,
                                  void* stream) {
  if (bad_shape(B, Cx, Cy, X, Y, s) || B > 65535 || rows < 1 ||
      threads < 32 || threads > FIELD_MAX_THREADS || threads % 32 != 0 ||
      reinterpret_cast<uintptr_t>(field) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((X + rows - 1) / rows, B);
  field_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      Cx, Cy, X, Y, s, rows, reinterpret_cast<const float4*>(table),
      reinterpret_cast<const float2*>(control),
      reinterpret_cast<float2*>(field));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ukbb_bspline_field_adjoint(int B, int Cx, int Cy, int X, int Y,
                                          int s, int ni, int nj, int rows,
                                          int width, const float* table,
                                          const float* grad_field,
                                          float* grad_control, void* stream) {
  if (bad_shape(B, Cx, Cy, X, Y, s) || ni < 1 || nj < 1 || rows < 1 ||
      width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = width < ADJOINT_THREADS ? width : ADJOINT_THREADS;
  const size_t smem =
      static_cast<size_t>(4 * s) * sizeof(float) +
      (2 * ((static_cast<size_t>(rows) * slice + 1) & ~static_cast<size_t>(1)) +
       static_cast<size_t>(ni) * width) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  adjoint_kernel<<<static_cast<unsigned>(B), ADJOINT_THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      Cx, Cy, X, Y, s, ni, nj, rows, width, table,
      reinterpret_cast<const float2*>(grad_field),
      reinterpret_cast<float2*>(grad_control));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ukbb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
