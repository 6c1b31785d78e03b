// Grouped ADC MVM for Hopper (sm_90a): kernels B1 and B2 of the port.
//
// Replaces the JAX package's Pallas kernels
//   B1  kernels/cim_mvm.py:cim_mvm_grouped_packed  (_cim_mvm_packed_kernel)
//   B2  kernels/cim_mvm.py:cim_mvm_grouped         (_cim_mvm_kernel)
//
//   y[m, n] = sum_g lsb * clip(rint(inv_lsb * sum_{r<R} x[m, R g + r] * w[R g + r, n]), 0, L-1)
//
// with R = n_rows (144) rows per macro group. x holds f32 DAC codes 0..15;
// w holds stored codes 0..15, dense f32 [K, N] (B2) or nibble-packed uint8
// [K2, N] (B1: row 2i in the low nibble, 2i+1 in the high). Rows past K
// (and byte rows past K2) read as zero codes, which is exactly the zero
// padding the reference applies, so no operand is ever copied to pad it.
//
// What bounds it on the H100: at decode M is the number of serving slots
// (4), so every weight byte feeds 4 multiply-adds. The kernel is bound by
// the bytes of weights it reads (K/2 * N for B1), far below the card's
// compute roofline.
//
// What the design does about that:
//  * one thread block owns a tile of 32 output columns x BM rows and walks
//    the groups itself; K is never split across blocks, so no atomics and
//    no second pass. One lane owns one column, so a warp reads 32
//    consecutive weight bytes (one sector) per row; the 16 warps of the
//    block take 16 groups at once (all of a K = 2048 row), which keeps 16x
//    more loads in flight than one warp walking K would.
//  * a group's MAC is an exact integer <= 144 * 15 * 15 = 32400, so the
//    f32 fused multiply-adds reproduce it bit for bit in any order.
//  * the ADC happens in registers: rint (round half to even, as
//    jnp.round) of an explicitly rounded product with inv_lsb, then the
//    clip. Each warp parks its group's codes in shared memory, and after a
//    barrier the block adds code * lsb to the outputs in ascending group
//    order as one explicit __fmaf_rn(code, lsb, o): the reference's
//    o += code * lsb, which XLA evaluates as a fused multiply-add (checked
//    against the Pallas kernel in interpret mode; a separate multiply and
//    add differ in the last bit).
//  * weights are unpacked in registers (B1), 4 bits each from device
//    memory, as in the SRAM array.
// Later work: wider loads (16 bytes a lane), TMA pipelines, and int8 MMA
// for prefill-sized M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;           // groups in flight per block
constexpr int kCols = 32;            // output columns per block (one per lane)
constexpr int kThreads = kWarps * 32;

template <int BM, bool PACKED>
__global__ void __launch_bounds__(kThreads)
cim_mvm_kernel(const float* __restrict__ x, const void* __restrict__ w,
               float* __restrict__ out, int M, int N, int K, int KW,
               int n_rows, int G, float inv_lsb, float lsb, float code_max) {
  extern __shared__ float smem[];
  float* xs = smem;                                // [kWarps][BM][n_rows]
  float* cs = smem + kWarps * BM * n_rows;         // [kWarps][BM][kCols]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  constexpr int kOwn = (BM * kCols + kThreads - 1) / kThreads;
  float o[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) o[i] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kWarps) {
    // stage the activation codes of groups g0 .. g0+kWarps-1
    const int tile = BM * n_rows;
    for (int idx = threadIdx.x; idx < kWarps * tile; idx += kThreads) {
      const int wg = idx / tile;
      const int rem = idx - wg * tile;
      const int mm = rem / n_rows;
      const int k = (g0 + wg) * n_rows + (rem - mm * n_rows);
      const int m = m0 + mm;
      xs[idx] = (g0 + wg < G && m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();

    const int g = g0 + warp;
    if (g < G) {
      float acc[BM];
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) acc[mm] = 0.f;
      const float* xw = xs + warp * tile;
      if (n < N) {
        if (PACKED) {
          const uint8_t* wp = static_cast<const uint8_t*>(w);
          const int half = n_rows >> 1;
          const int row0 = g * half;
#pragma unroll 8
          for (int rr = 0; rr < half; ++rr) {
            const int row = row0 + rr;
            const int b = row < KW ? wp[(size_t)row * N + n] : 0;
            const float lo = (float)(b & 15);
            const float hi = (float)(b >> 4);
#pragma unroll
            for (int mm = 0; mm < BM; ++mm) {
              acc[mm] = fmaf(xw[mm * n_rows + 2 * rr], lo, acc[mm]);
              acc[mm] = fmaf(xw[mm * n_rows + 2 * rr + 1], hi, acc[mm]);
            }
          }
        } else {
          const float* wf = static_cast<const float*>(w);
          const int row0 = g * n_rows;
#pragma unroll 8
          for (int r = 0; r < n_rows; ++r) {
            const int row = row0 + r;
            const float wv = row < KW ? wf[(size_t)row * N + n] : 0.f;
#pragma unroll
            for (int mm = 0; mm < BM; ++mm)
              acc[mm] = fmaf(xw[mm * n_rows + r], wv, acc[mm]);
          }
        }
      }
      // TD-ADC transfer in registers
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) {
        float c = rintf(__fmul_rn(acc[mm], inv_lsb));
        c = fminf(fmaxf(c, 0.f), code_max);
        cs[(warp * BM + mm) * kCols + lane] = c;
      }
    }
    __syncthreads();

    // digital partial-sum accumulation, ascending group order
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < BM * kCols) {
        for (int wg = 0; wg < kWarps && g0 + wg < G; ++wg)
          o[i] = __fmaf_rn(cs[wg * BM * kCols + e], lsb, o[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < BM * kCols) {
      const int m = m0 + e / kCols;
      const int nn = blockIdx.x * kCols + e % kCols;
      if (m < M && nn < N) out[(size_t)m * N + nn] = o[i];
    }
  }
}

template <int BM, bool PACKED>
int launch(const float* x, const void* w, float* out, int M, int N, int K,
           int KW, int n_rows, int G, float inv_lsb, float lsb,
           float code_max, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * BM * (n_rows + kCols);
  // raise the dynamic shared-memory cap once per instantiation and size
  // (not on every launch: a launch may be captured into a CUDA graph)
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        cim_mvm_kernel<BM, PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  cim_mvm_kernel<BM, PACKED><<<grid, kThreads, smem, stream>>>(
      x, w, out, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int dispatch(const float* x, const void* w, float* out, int M, int N, int K,
             int KW, int n_rows, int G, float inv_lsb, float lsb,
             float code_max, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M <= 4)
    return launch<4, PACKED>(x, w, out, M, N, K, KW, n_rows, G, inv_lsb, lsb,
                             code_max, stream);
  return launch<8, PACKED>(x, w, out, M, N, K, KW, n_rows, G, inv_lsb, lsb,
                           code_max, stream);
}

}  // namespace

extern "C" {

// B2: x [M, K] f32, w [K, N] f32 codes, out [M, N] f32.
int cim_mvm_dense_launch(const float* x, const float* w, float* out, int M,
                         int N, int K, int n_rows, float inv_lsb, float lsb,
                         float code_max, cudaStream_t stream) {
  int G = (K + n_rows - 1) / n_rows;
  if (G < 1) G = 1;
  return dispatch<false>(x, w, out, M, N, K, K, n_rows, G, inv_lsb, lsb,
                         code_max, stream);
}

// B1: x [M, K] f32, w [K2, N] uint8 nibble pairs (K <= 2 K2), out [M, N] f32.
int cim_mvm_packed_launch(const float* x, const uint8_t* w, float* out,
                          int M, int N, int K, int K2, int n_rows,
                          float inv_lsb, float lsb, float code_max,
                          cudaStream_t stream) {
  int G = (2 * K2 + n_rows - 1) / n_rows;
  if (G < 1) G = 1;
  return dispatch<true>(x, w, out, M, N, K, K2, n_rows, G, inv_lsb, lsb,
                        code_max, stream);
}

}  // extern "C"
