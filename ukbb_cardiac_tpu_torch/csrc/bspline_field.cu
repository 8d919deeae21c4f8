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
// by bytes, and at these sizes by launch latency.  The design keeps device-memory traffic at the bound: the
// forward writes each output once, coalesced (neighbouring threads write
// neighbouring float2), and reads the small lattice through the read-only
// cache; the adjoint reads each cotangent row coalesced and keeps its
// x-reduced partial sums in shared memory.
//
// Two kernels on the caller's stream:
//   field_kernel: one thread per column y and run of s rows x = q*s + r
//     (all of which read the same 4 control rows), both components, on a
//     (y / 32, q / 4, b) grid with 32-bit index arithmetic.  The thread
//     reduces the 4 control rows over their 4 columns once (16 loads
//     through the read-only cache), then writes its s pixels with 4 FMAs
//     each: Bx @ (C @ By^T), the inner sum over c (y) first.
//   adjoint_kernel: one block per (b, i).  Pass 1: each thread owns columns
//     y and sums the 4s rows x of control i's support, walked as (q, r)
//     pairs in ascending x without a division, into a shared (Y, 2) buffer.
//     Pass 2: each thread owns controls j and sums the 4s columns of its
//     support.  Fixed loop orders and no atomics: two runs agree bit for
//     bit.
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int FIELD_TILE_Y = 32;  // threads along y: one warp, coalesced
constexpr int FIELD_TILE_Q = 4;   // runs of s rows x per block
constexpr int ADJOINT_THREADS = 128;

__global__ void field_kernel(int Cx, int Cy, int X, int Y, int s,
                             const float* __restrict__ table,
                             const float2* __restrict__ ctl,
                             float2* __restrict__ out) {
  extern __shared__ float w[];  // (s, 4)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < 4 * s; t += blockDim.x * blockDim.y) w[t] = table[t];
  __syncthreads();
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y * blockDim.y + threadIdx.y;  // rows q*s .. q*s+s-1
  const int b = blockIdx.z;
  const int x0 = q * s;
  if (y >= Y || x0 >= X) return;
  const int qy = y / s;
  const float* wy = w + (y - qy * s) * 4;
  const float2* c = ctl + static_cast<size_t>(b) * Cx * Cy;
  // the 4 control rows i = q + a these pixels read, reduced over their 4
  // columns j = qy + k: one set of lattice loads serves all s rows
  float2 row[4];
  for (int a = 0; a < 4; ++a) {
    const int i = q + a;
    float rx = 0.f, ry = 0.f;
    if (i < Cx) {
      for (int k = 0; k < 4; ++k) {
        const int j = qy + k;
        if (j >= Cy) break;
        const float2 v = __ldg(c + i * Cy + j);
        rx = fmaf(wy[k], v.x, rx);
        ry = fmaf(wy[k], v.y, ry);
      }
    }
    row[a] = make_float2(rx, ry);
  }
  const int n = min(s, X - x0);
  float2* o = out + (static_cast<size_t>(b) * X + x0) * Y + y;
  for (int r = 0; r < n; ++r) {
    const float* wx = w + r * 4;
    float ax = 0.f, ay = 0.f;
    for (int a = 0; a < 4; ++a) {
      ax = fmaf(wx[a], row[a].x, ax);
      ay = fmaf(wx[a], row[a].y, ay);
    }
    o[static_cast<size_t>(r) * Y] = make_float2(ax, ay);
  }
}

__global__ void adjoint_kernel(int Cx, int Cy, int X, int Y, int s,
                               const float* __restrict__ table,
                               const float2* __restrict__ g,
                               float2* __restrict__ out) {
  extern __shared__ float sm[];
  float* w = sm;                                        // (s, 4)
  float2* part = reinterpret_cast<float2*>(sm + 4 * s);  // (Y,), 8-aligned
  for (int t = threadIdx.x; t < 4 * s; t += blockDim.x) w[t] = table[t];
  __syncthreads();
  const int b = blockIdx.x / Cx;
  const int i = blockIdx.x - b * Cx;
  const float2* gb = g + static_cast<size_t>(b) * X * Y;
  // rows x = q*s + r with Bx[x, i] = w[r][i - q] != 0: q = i-3 .. i, in
  // ascending x
  for (int y = threadIdx.x; y < Y; y += blockDim.x) {
    float px = 0.f, py = 0.f;
    for (int a = 3; a >= 0; --a) {
      const int x0 = (i - a) * s;
      const int r0 = max(0, -x0), r1 = min(s, X - x0);
      for (int r = r0; r < r1; ++r) {
        const float wt = w[r * 4 + a];
        const float2 v = gb[static_cast<size_t>(x0 + r) * Y + y];
        px = fmaf(wt, v.x, px);
        py = fmaf(wt, v.y, py);
      }
    }
    part[y] = make_float2(px, py);
  }
  __syncthreads();
  float2* ob = out + (static_cast<size_t>(b) * Cx + i) * Cy;
  for (int j = threadIdx.x; j < Cy; j += blockDim.x) {
    float ax = 0.f, ay = 0.f;
    for (int a = 3; a >= 0; --a) {
      const int y0 = (j - a) * s;
      const int r0 = max(0, -y0), r1 = min(s, Y - y0);
      for (int r = r0; r < r1; ++r) {
        const float wt = w[r * 4 + a];
        const float2 v = part[y0 + r];
        ax = fmaf(wt, v.x, ax);
        ay = fmaf(wt, v.y, ay);
      }
    }
    ob[j] = make_float2(ax, ay);
  }
}

bool bad_shape(int B, int Cx, int Cy, int X, int Y, int s) {
  return B < 1 || Cx < 1 || Cy < 1 || X < 1 || Y < 1 || s < 1;
}

}  // namespace

extern "C" int ukbb_bspline_field(int B, int Cx, int Cy, int X, int Y, int s,
                                  const float* table, const float* control,
                                  float* field, void* stream) {
  if (bad_shape(B, Cx, Cy, X, Y, s) || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (X + s - 1) / s;  // residue runs of s pixel rows
  const dim3 block(FIELD_TILE_Y, FIELD_TILE_Q);
  const dim3 grid((Y + FIELD_TILE_Y - 1) / FIELD_TILE_Y,
                  (rows + FIELD_TILE_Q - 1) / FIELD_TILE_Q, B);
  const size_t smem = static_cast<size_t>(4 * s) * sizeof(float);
  field_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      Cx, Cy, X, Y, s, table, reinterpret_cast<const float2*>(control),
      reinterpret_cast<float2*>(field));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ukbb_bspline_field_adjoint(int B, int Cx, int Cy, int X, int Y,
                                          int s, const float* table,
                                          const float* grad_field,
                                          float* grad_control, void* stream) {
  if (bad_shape(B, Cx, Cy, X, Y, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(4 * s) * sizeof(float) +
                      static_cast<size_t>(Y) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  adjoint_kernel<<<static_cast<unsigned>(B) * static_cast<unsigned>(Cx),
                   ADJOINT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      Cx, Cy, X, Y, s, table, reinterpret_cast<const float2*>(grad_field),
      reinterpret_cast<float2*>(grad_control));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ukbb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
