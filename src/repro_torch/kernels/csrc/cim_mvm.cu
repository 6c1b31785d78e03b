// Grouped ADC MVM for Hopper (sm_90a): kernels B1, B2, B5 and B6 of the port.
//
// Replaces the JAX package's Pallas kernels
//   B1  kernels/cim_mvm.py:cim_mvm_grouped_packed        (_cim_mvm_packed_kernel)
//   B2  kernels/cim_mvm.py:cim_mvm_grouped               (_cim_mvm_kernel)
//   B5  kernels/cim_mvm.py:cim_mvm_grouped_noisy         (_cim_mvm_noisy_kernel)
//   B6  kernels/cim_mvm.py:cim_mvm_grouped_noisy_packed  (_cim_mvm_noisy_packed_kernel)
//
//   y[m, n] = sum_g lsb * clip(rint(T(sum_{r<R} x[m, R g + r] * w[R g + r, n])), 0, L-1)
//
// with R = n_rows (144) rows per macro group. x holds f32 DAC codes 0..15;
// w holds stored codes 0..15, dense f32 [K, N] (B2) or nibble-packed uint8
// [K2, N] (B1: row 2i in the low nibble, 2i+1 in the high). Rows past K
// (and byte rows past K2) read as zero codes, which is exactly the zero
// padding the reference applies, so no operand is ever copied to pad it.
//
// T(part) = part * inv_lsb at the IDEAL sim level (B1, B2). B5 and B6
// are B2 and B1 with the NOISY/FULL converter (template MODE): at FULL the
// INL instance's curve is added first, x = fma(part, inv_lsb,
// inl(clip(part * (inv_lsb / L), 0, 1))), the constants folded as XLA
// folds them in the reference kernel; then thermal noise,
// x = fma(sigma, n, x), where n ~ N(0, 1) is the Irwin-Hall sum of 12
// uniforms drawn from a murmur3-finalizer hash of (seed ^ salt, GLOBAL row,
// GLOBAL column, group). The seed is read from a 1-element device tensor,
// so a new seed needs no rebuild and no host sync (and the launch can be
// captured in a CUDA graph). The draw depends on neither the tiling nor the
// weight container: B6 equals B5 bit for bit. Both additions are fused
// multiply-adds because XLA contracts them when it runs the reference
// kernel (checked on crafted rounding ties); the 12 uniforms are added in
// order with __fadd_rn; sinf (never __sinf) evaluates the INL curve, whose
// f32 constants the host computes from the reference's RandomState draws.
//
// What bounds it on the H100: at decode M is the number of serving slots
// (4), so every weight byte feeds 4 multiply-adds. B1/B2 are bound by the
// bytes of weights they read (K/2 * N for B1), far below the card's compute
// roofline. B5/B6 add ~120 integer operations per conversion (13 murmur3
// finalizers): B6 is bound by that hash work on the INT32 lanes, B5 still by
// its 4-byte dense weight codes.
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
//  * stochastic kernels: the row and column stay fixed for a thread across
//    all groups, so their two hash absorptions are computed once per row
//    before the group loop; each conversion then costs one finalizer for
//    its group and twelve for its uniforms.
// Later work: wider loads (16 bytes a lane), TMA pipelines, and int8 MMA
// for prefill-sized M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;           // groups in flight per block
constexpr int kCols = 32;            // output columns per block (one per lane)
constexpr int kThreads = kWarps * 32;

enum Mode { kIdeal = 0, kNoisy = 1, kFull = 2 };

constexpr uint32_t kGolden = 0x9E3779B9u;   // 2^32 / phi

// Stochastic converter settings (unused at IDEAL).
struct Stochastic {
  const int* seed;     // 1-element device tensor
  uint32_t salt;       // salt_seed's XOR term for inl_seed
  float sigma;         // pre-rounding thermal sigma, LSB units
  float frac_scale;    // f32 inv_lsb / L: part -> the INL curve's code fraction
  // INL instance (FULL): f32 constants from the host
  float sign, ripple0, ripple1, phase0, phase1, norm, bow, jitter, two_pi;
};

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// N(0, 1): Irwin-Hall sum of 12 uniforms, draw j = mix32(base + j * golden)
// converted to f32 (round to nearest) and added in order j = 1..12.
__device__ __forceinline__ float normal12(uint32_t base) {
  float acc = 0.f;
#pragma unroll
  for (uint32_t j = 1; j <= 12; ++j)
    acc = __fadd_rn(acc, __uint2float_rn(mix32(base + j * kGolden)));
  return __fsub_rn(__fmul_rn(acc, 0x1p-32f), 6.f);
}

// The reference's inl_curve in its evaluation order (u^3 = u * (u * u), as
// XLA's integer_pow; fused multiply-adds where XLA fuses them).
__device__ __forceinline__ float inl_curve(float cf, const Stochastic& s) {
  const float u = __fsub_rn(__fmul_rn(cf, 2.f), 1.f);
  const float xa = __fmul_rn(cf, s.two_pi);
  const float s1 = sinf(__fadd_rn(__fmul_rn(xa, 2.f), s.phase0));
  const float s2 = sinf(__fmaf_rn(3.f, xa, s.phase1));
  const float bow = __fmul_rn(__fmul_rn(u, __fmul_rn(u, u)), s.sign);
  float curve = __fmaf_rn(s.ripple1, s2, __fmaf_rn(s.ripple0, s1, bow));
  curve = __fdiv_rn(curve, s.norm);
  const float j1 = sinf(__fmaf_rn(cf, 12289.f, s.phase0));
  const float j2 = sinf(__fmaf_rn(cf, 5741.f, s.phase1));
  return __fmaf_rn(__fmul_rn(j1, s.jitter), j2, __fmul_rn(curve, s.bow));
}

template <int BM, bool PACKED, int MODE>
__global__ void __launch_bounds__(kThreads)
cim_mvm_kernel(const float* __restrict__ x, const void* __restrict__ w,
               float* __restrict__ out, int M, int N, int K, int KW,
               int n_rows, int G, float inv_lsb, float lsb, float code_max,
               Stochastic st) {
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
  // hash state after absorbing the salted seed, the row and the column
  uint32_t hrc[MODE == kIdeal ? 1 : BM];
  if constexpr (MODE != kIdeal) {
    const uint32_t h0 = mix32(((uint32_t)__ldg(st.seed) ^ st.salt) ^ kGolden);
#pragma unroll
    for (int mm = 0; mm < BM; ++mm)
      hrc[mm] = mix32(mix32(h0 ^ (uint32_t)(m0 + mm)) ^ (uint32_t)n);
  }

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
        float v = __fmul_rn(acc[mm], inv_lsb);
        if constexpr (MODE == kFull) {
          const float cf =
              fminf(fmaxf(__fmul_rn(acc[mm], st.frac_scale), 0.f), 1.f);
          v = __fmaf_rn(acc[mm], inv_lsb, inl_curve(cf, st));
        }
        if constexpr (MODE != kIdeal) {
          const uint32_t base = mix32(hrc[mm] ^ ((uint32_t)g * 0x01000193u));
          v = __fmaf_rn(st.sigma, normal12(base), v);
        }
        float c = rintf(v);
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

template <int BM, bool PACKED, int MODE>
int launch(const float* x, const void* w, float* out, int M, int N, int K,
           int KW, int n_rows, int G, float inv_lsb, float lsb,
           float code_max, const Stochastic& st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * BM * (n_rows + kCols);
  // raise the dynamic shared-memory cap once per instantiation and size
  // (not on every launch: a launch may be captured into a CUDA graph)
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        cim_mvm_kernel<BM, PACKED, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  cim_mvm_kernel<BM, PACKED, MODE><<<grid, kThreads, smem, stream>>>(
      x, w, out, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st);
  return (int)cudaGetLastError();
}

template <bool PACKED, int MODE>
int dispatch_rows(const float* x, const void* w, float* out, int M, int N,
                  int K, int KW, int n_rows, int G, float inv_lsb, float lsb,
                  float code_max, const Stochastic& st, cudaStream_t stream) {
  if (M <= 4)
    return launch<4, PACKED, MODE>(x, w, out, M, N, K, KW, n_rows, G,
                                   inv_lsb, lsb, code_max, st, stream);
  return launch<8, PACKED, MODE>(x, w, out, M, N, K, KW, n_rows, G, inv_lsb,
                                 lsb, code_max, st, stream);
}

template <bool PACKED>
int dispatch(const float* x, const void* w, float* out, int M, int N, int K,
             int KW, int n_rows, int G, float inv_lsb, float lsb,
             float code_max, int mode, const Stochastic& st,
             cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  switch (mode) {
    case kIdeal:
      return dispatch_rows<PACKED, kIdeal>(x, w, out, M, N, K, KW, n_rows, G,
                                           inv_lsb, lsb, code_max, st, stream);
    case kNoisy:
      return dispatch_rows<PACKED, kNoisy>(x, w, out, M, N, K, KW, n_rows, G,
                                           inv_lsb, lsb, code_max, st, stream);
    case kFull:
      return dispatch_rows<PACKED, kFull>(x, w, out, M, N, K, KW, n_rows, G,
                                          inv_lsb, lsb, code_max, st, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// inl: host array {frac_scale, sign, ripple0, ripple1, phase0, phase1,
// norm, bow, jitter, two_pi}, read at launch time.
Stochastic make_stochastic(const int* seed, unsigned salt, float sigma,
                           const float* inl) {
  Stochastic st{seed,   salt,   sigma,  inl[0], inl[1], inl[2], inl[3],
                inl[4], inl[5], inl[6], inl[7], inl[8], inl[9]};
  return st;
}

int groups(int K, int n_rows) {
  const int G = (K + n_rows - 1) / n_rows;
  return G < 1 ? 1 : G;
}

}  // namespace

extern "C" {

// B2: x [M, K] f32, w [K, N] f32 codes, out [M, N] f32.
int cim_mvm_dense_launch(const float* x, const float* w, float* out, int M,
                         int N, int K, int n_rows, float inv_lsb, float lsb,
                         float code_max, cudaStream_t stream) {
  const Stochastic none{};
  return dispatch<false>(x, w, out, M, N, K, K, n_rows, groups(K, n_rows),
                         inv_lsb, lsb, code_max, kIdeal, none, stream);
}

// B1: x [M, K] f32, w [K2, N] uint8 nibble pairs (K <= 2 K2), out [M, N] f32.
int cim_mvm_packed_launch(const float* x, const uint8_t* w, float* out,
                          int M, int N, int K, int K2, int n_rows,
                          float inv_lsb, float lsb, float code_max,
                          cudaStream_t stream) {
  const Stochastic none{};
  return dispatch<true>(x, w, out, M, N, K, K2, n_rows, groups(2 * K2, n_rows),
                        inv_lsb, lsb, code_max, kIdeal, none, stream);
}

// B5: B2 with the stochastic converter; mode 1 = NOISY, 2 = FULL; seed is a
// 1-element int32 device tensor.
int cim_mvm_noisy_dense_launch(const float* x, const float* w, float* out,
                               int M, int N, int K, int n_rows,
                               float inv_lsb, float lsb, float code_max,
                               int mode, const int* seed, unsigned salt,
                               float sigma, const float* inl,
                               cudaStream_t stream) {
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<false>(x, w, out, M, N, K, K, n_rows, groups(K, n_rows),
                         inv_lsb, lsb, code_max, mode, st, stream);
}

// B6: B1 with the stochastic converter (bit-identical to B5).
int cim_mvm_noisy_packed_launch(const float* x, const uint8_t* w, float* out,
                                int M, int N, int K, int K2, int n_rows,
                                float inv_lsb, float lsb, float code_max,
                                int mode, const int* seed, unsigned salt,
                                float sigma, const float* inl,
                                cudaStream_t stream) {
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<true>(x, w, out, M, N, K, K2, n_rows,
                        groups(2 * K2, n_rows), inv_lsb, lsb, code_max, mode,
                        st, stream);
}

}  // extern "C"
