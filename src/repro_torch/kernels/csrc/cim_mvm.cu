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
// bytes of weights they read (K/2 * N bytes for B1, K * N * 4 for B2), far
// below the card's compute roofline. B5/B6 add ~120 integer operations per
// conversion (13 murmur3 finalizers): B6 is bound by that hash work on the
// INT32 lanes, B5 still by its 4-byte dense weight codes. At a prefill
// chunk (M = 64) B2/B5 do 64 f32 multiply-adds per weight instead of 4.
//
// What every kernel here does about it:
//  * a group's MAC is an exact integer <= n_rows * 15 * 15 (32400 at 144
//    rows; below 2^24 up to 74565 rows), so it may be formed in any order
//    and anywhere (f32 fused multiply-adds in B2/B5, int8 dot products in
//    B1/B6), and split over lanes: the codes are the same.
//  * the ADC happens in registers: rint (round half to even, as
//    jnp.round) of an explicitly rounded product with inv_lsb, then the
//    clip. The codes are parked in shared memory, and code * lsb is added
//    to each output in ascending group order as one explicit
//    __fmaf_rn(code, lsb, o): the reference's o += code * lsb, which XLA
//    evaluates as a fused multiply-add (checked against the Pallas kernel
//    in interpret mode; a separate multiply and add differ in the last
//    bit). Only this digital accumulation has an order that matters.
//  * stochastic kernels: the row and column stay fixed for a lane across
//    all groups, so their two hash absorptions are computed once before
//    the group loop; each conversion then costs one finalizer for its
//    group and twelve for its uniforms.
//  * 16-byte weight loads, several rows in flight per lane, the first
//    ones issued before the activation staging and its barrier, the next
//    group's before the current group's ADC; the group axis split over a
//    thread-block cluster (cudaLaunchKernelEx with a cluster dimension)
//    wherever the column tiles alone would leave SMs idle, each rank
//    converting its own groups and the cluster finalising the outputs over
//    distributed shared memory; wide matrices (the head, prefill-sized M)
//    put up to 8 warps side by side along the columns instead, so that
//    one CTA's staged activation codes serve more columns.
//
// B1/B6 (cim_mvm_packed_kernel): every lane loads 16 bytes (16 columns of
// one byte row) at a time; the nibbles are rearranged in registers into
// int8x4 words and multiplied by __dp4a (four exact multiply-adds per
// instruction). The split aims at ~64 CTAs: at M = 4 the 2048-wide MVMs
// take clusters of 2 and the 1024-wide ones clusters of 4.
//
// B1/B6 and B2/B5 expert-batched (the MoE routed experts, which the
// reference runs as jax.vmap of its kernels): x [E, M, K], w [E, K2, N]
// (or dense [E, K, N]) -> out [E, M, N] in one launch, grid z over
// (expert, row tile). Separate template instances (EXPERTS = true), so the
// 2-D instances compile as before. Rows and groups are counted within an
// expert, so an expert's outputs, and under NOISY/FULL its noise draws,
// are those of a 2-D launch on its own operands.
//
// B2/B5 (cim_mvm_dense_kernel): a lane loads a float4 (4 columns of one
// f32 weight row) for each of U = 9 rows at once (144 bytes in flight per
// lane, at both tile heights). The f32 container carries 8x the bytes of
// the packed one per weight, so the split aims at ~2048 warps (two 8-warp
// CTAs per SM) over the fewest ranks: at M = 4 wq/wo, wk/wv and w_down
// take clusters of 2, w_gate/w_up and the head none; at a prefill chunk a
// larger cluster keeps each CTA within half an SM's shared memory (two
// CTAs per SM). The MAC stays in f32 FMAs (no F2I into int8 words: F2I runs at a quarter
// rate, and a decode step's 6.8 G FMAs are ~0.2 ms at 67 TFLOP/s, far
// under its 2 ms of weight bytes). The activations are staged once per
// CTA, by cp.async copies that are all in flight at once (a loop of
// dependent loads cost more than the weights at decode), with a row's BM
// values side by side, so one 16-byte shared load feeds 4 x BM FMAs. It
// takes every macro depth n_rows >= 1: a lane takes every S-th row of its
// group (any remainder), and where a cluster rank's groups do not fit in
// shared memory even over 8 ranks the CTA runs without a cluster and
// stages its groups in passes (adding each pass's codes to its outputs in
// ascending group order), or a single group's rows in windows when one
// group alone does not fit.
//
// cim_mvm_kernel, the first design's body (one block per 32 columns, 16
// warps over up to 16 groups at a time), is kept only for B1/B6 where the
// packed kernel cannot take the shape: groups of rows that are no multiple
// of four (an int8x4 word would straddle two groups), or more shared
// memory than a CTA has. It stages fewer groups per pass where 16 do not
// fit. Later work: a TMA/cp.async weight pipeline, and tensor-core MMA for
// prefill-sized M.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;           // groups in flight per block
constexpr int kCols = 32;            // output columns per block (one per lane)
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemMax = 227 * 1024;   // dynamic shared memory of a CTA

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

// The packed fallback: one block per 32 columns x BM rows, `gpp` warps (at
// most kWarps) each converting one group of a pass. EXPERTS: grid z is the
// expert, each one an [M, K] x [KW, N] problem of its own.
template <int BM, int MODE, bool EXPERTS>
__global__ void __launch_bounds__(kThreads)
cim_mvm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
               float* __restrict__ out, int M, int N, int K, int KW,
               int n_rows, int G, int gpp, float inv_lsb, float lsb,
               float code_max, Stochastic st) {
  extern __shared__ float smem[];
  if constexpr (EXPERTS) {
    x += (size_t)blockIdx.z * M * K;
    w += (size_t)blockIdx.z * KW * N;
    out += (size_t)blockIdx.z * M * N;
  }
  float* xs = smem;                                // [gpp][BM][n_rows]
  float* cs = smem + gpp * BM * n_rows;            // [gpp][BM][kCols]
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

  for (int g0 = 0; g0 < G; g0 += gpp) {
    // stage the activation codes of groups g0 .. g0+gpp-1
    const int tile = BM * n_rows;
    for (int idx = threadIdx.x; idx < gpp * tile; idx += kThreads) {
      const int wg = idx / tile;
      const int rem = idx - wg * tile;
      const int mm = rem / n_rows;
      const int k = (g0 + wg) * n_rows + (rem - mm * n_rows);
      const int m = m0 + mm;
      xs[idx] = (g0 + wg < G && m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();

    const int g = g0 + warp;
    if (warp < gpp && g < G) {
      float acc[BM];
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) acc[mm] = 0.f;
      const float* xw = xs + warp * tile;
      if (n < N) {
        const int half = n_rows >> 1;
        const int row0 = g * half;
#pragma unroll 8
        for (int rr = 0; rr < half; ++rr) {
          const int row = row0 + rr;
          const int b = row < KW ? w[(size_t)row * N + n] : 0;
          const float lo = (float)(b & 15);
          const float hi = (float)(b >> 4);
#pragma unroll
          for (int mm = 0; mm < BM; ++mm) {
            acc[mm] = fmaf(xw[mm * n_rows + 2 * rr], lo, acc[mm]);
            acc[mm] = fmaf(xw[mm * n_rows + 2 * rr + 1], hi, acc[mm]);
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
        for (int wg = 0; wg < gpp && g0 + wg < G; ++wg)
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

// Launches the fallback with as many groups per pass (up to kWarps) as
// the CTA's shared memory holds; an error where not even one group fits.
// E experts (EXPERTS) take grid z.
template <int BM, int MODE, bool EXPERTS>
int launch_fallback(const float* x, const uint8_t* w, float* out, int E,
                    int M, int N, int K, int KW, int n_rows, int G,
                    float inv_lsb, float lsb, float code_max,
                    const Stochastic& st, cudaStream_t stream) {
  const size_t per_group = sizeof(float) * (size_t)BM * (n_rows + kCols);
  const int gpp = (int)std::min<size_t>(kWarps, kSmemMax / per_group);
  if (gpp < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per_group * gpp;
  // raise the dynamic shared-memory cap once per instantiation and size
  // (not on every launch: a launch may be captured into a CUDA graph)
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        cim_mvm_kernel<BM, MODE, EXPERTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  if (E > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM, E);
  cim_mvm_kernel<BM, MODE, EXPERTS><<<grid, kThreads, smem, stream>>>(
      x, w, out, M, N, K, KW, n_rows, G, gpp, inv_lsb, lsb, code_max, st);
  return (int)cudaGetLastError();
}

// ---- B1 / B6: the packed kernel, group axis split over a cluster -------
//
// A warp owns NC = 4 * VB output columns x BM rows; a CTA holds `wcols`
// such warps side by side and `wgs` rows of them that take the CTA's
// `gpc` consecutive groups in turn; the cluster's CTAs (grid y, cluster
// dims (1, CS, 1)) own the G groups between them. The activation codes
// of the CTA's groups are staged once in shared memory as int8x4 words.
// For each of its groups a warp's lane
// (chunk = lane % 4, slice = lane / 4) loads VB bytes (VB columns) of two
// consecutive byte rows, i.e. four consecutive weight rows, for every
// fourth-row quad p = slice, slice + 8, ... of the group, all of them at
// once (up to kQuads quads in flight per lane). The nibbles are
// rearranged in registers into one int8x4 word per column (its four
// weight rows) and multiplied with the matching int8x4 word of
// activation codes by __dp4a: four exact integer multiply-adds in one
// instruction. The 8 slices are summed by a three-step reduce-scatter
// over the lanes (exact integers), which leaves each lane VB / 8 columns x
// BM rows of group sums; the ADC converts them (as f32, exact below 2^24)
// in registers and the codes go to this CTA's shared memory. After
// cluster.sync() every CTA finalises a slice of the tile's outputs,
// reading every group's code through distributed shared memory in
// ascending group order, one __fmaf_rn(code, lsb, o) per group.
constexpr int kSlices = 8;            // quad slices per group (lane bits 2-4)
constexpr int kChunks = 4;            // column chunks per warp (lane bits 0-1)
constexpr int kQuads = 5;             // quads a lane loads at once
constexpr int kGroupWarps = 8;        // warps per CTA at most
constexpr int kMaxCluster = 8;        // portable cluster size
constexpr int kCtaTarget = 64;        // CTAs the cluster split aims for
constexpr int kWideTiles = 256;       // CTA tiles left after widening

// Launch knobs from the tuning cache (kernels/autotune.py): the cluster
// size and the column warps a launcher asks for, 0 for its own choice.
// Neither changes a bit of the output: a group's sum is an exact integer,
// and the codes are added to each output in one ascending chain however
// the groups are split over ranks and warps. `used`, when not null,
// receives the cluster size and the column warps launched ({0, 0}: the
// packed fallback body, which takes neither).
struct Knobs {
  int cluster, wcols;
  int* used;
  void report(int cs, int wc) const {
    if (used) {
      used[0] = cs;
      used[1] = wc;
    }
  }
};

// One step of the reduce-scatter: lanes `mask` apart swap halves of their
// first 2W columns; the lane with `upper` set keeps the upper half.
template <int W, int VB, int BM>
__device__ __forceinline__ void reduce_half(int (&acc)[VB][BM], int upper,
                                            int mask) {
#pragma unroll
  for (int c = 0; c < W; ++c)
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) {
      const int send = upper ? acc[c][mm] : acc[c + W][mm];
      const int keep = upper ? acc[c + W][mm] : acc[c][mm];
      acc[c][mm] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

template <int VB>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ w,
                                           size_t off, int cols_left,
                                           bool vec, uint32_t* out) {
  if (vec) {
    if (cols_left <= 0) {
#pragma unroll
      for (int q = 0; q < VB / 4; ++q) out[q] = 0u;
    } else if constexpr (VB == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + off));
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(w + off));
      out[0] = v.x; out[1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < VB / 4; ++q) {
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < cols_left)
        word |= (uint32_t)__ldg(w + off + 4 * q + j) << (8 * j);
    out[q] = word;
  }
}

// Four columns x four weight rows: r0 holds byte row 2p of four columns
// (weight rows 4p, 4p+1 in its nibbles), r1 byte row 2p+1 (4p+2, 4p+3).
// col[j] gets column j's rows 4p..4p+3 as int8x4, lowest row first.
__device__ __forceinline__ void quad_columns(uint32_t r0, uint32_t r1,
                                             int* col) {
  const uint32_t lo0 = r0 & 0x0F0F0F0Fu, hi0 = (r0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t lo1 = r1 & 0x0F0F0F0Fu, hi1 = (r1 >> 4) & 0x0F0F0F0Fu;
  const uint32_t a01 = __byte_perm(lo0, hi0, 0x5140);   // lo0.0 hi0.0 lo0.1 hi0.1
  const uint32_t a23 = __byte_perm(lo0, hi0, 0x7362);
  const uint32_t b01 = __byte_perm(lo1, hi1, 0x5140);
  const uint32_t b23 = __byte_perm(lo1, hi1, 0x7362);
  col[0] = (int)__byte_perm(a01, b01, 0x5410);
  col[1] = (int)__byte_perm(a01, b01, 0x7632);
  col[2] = (int)__byte_perm(a23, b23, 0x5410);
  col[3] = (int)__byte_perm(a23, b23, 0x7632);
}

template <int BM, int VB, int MODE, bool EXPERTS>
__global__ void __launch_bounds__(kGroupWarps * 32)
cim_mvm_packed_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ w, float* __restrict__ out,
                      int M, int N, int K, int KW, int n_rows, int G, int gpc,
                      int wcols, int vec, float inv_lsb, float lsb,
                      float code_max, Stochastic st) {
  constexpr int NC = kChunks * VB;    // columns per warp
  constexpr int VO = VB / 8;          // columns per lane after the reduction
  extern __shared__ float smem[];
  const int nct = wcols * NC;                       // columns per CTA
  const int nq = n_rows >> 2;                       // quads per group
  int* xq = reinterpret_cast<int*>(smem);           // [gpc][BM][nq] int8x4
  float* cs = smem + (size_t)gpc * BM * nq;         // [gpc][BM][nct] codes
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_rank = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wc = warp % wcols;                      // the warp's column tile
  const int wg = warp / wcols;                      // ... and group lane
  const int wgs = (blockDim.x >> 5) / wcols;
  const int n0 = blockIdx.x * nct + wc * NC;
  int mz = blockIdx.z;                              // the row tile
  if constexpr (EXPERTS) {
    // grid z runs over (expert, row tile); the expert's operands are the
    // next [M, K], [KW, N] and [M, N] blocks
    const int mt = (M + BM - 1) / BM;
    const int e = mz / mt;
    mz -= e * mt;
    x += (size_t)e * M * K;
    w += (size_t)e * KW * N;
    out += (size_t)e * M * N;
  }
  const int m0 = mz * BM;
  const int g0 = rank * gpc;
  const int ng = max(0, min(gpc, G - g0));
  const int chunk = lane & 3;
  const int slice = lane >> 2;
  const int half = n_rows >> 1;
  const int col = n0 + chunk * VB;                  // first column loaded

  // the first quads of the warp's first group: issued before anything waits
  uint32_t wv[kQuads][2][VB / 4];
  auto load_quads = [&](int gl, int p0) {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int p = p0 + i * kSlices;               // quad in the group
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int br = 2 * p + h;                   // byte row in the group
        const int row = (g0 + gl) * half + br;
        const bool ok = p < nq && row < KW;
        load_bytes<VB>(w, (size_t)row * N + col, ok ? N - col : 0, vec,
                       wv[i][h]);
      }
    }
  };
  if (wg < ng) load_quads(wg, slice);

  // this CTA's activation codes as int8x4 words (zero past M and K)
  const int tile = BM * nq;
  for (int idx = threadIdx.x; idx < ng * tile; idx += blockDim.x) {
    const int gl = idx / tile;
    const int rem = idx - gl * tile;
    const int mm = rem / nq;
    const int k = (g0 + gl) * n_rows + 4 * (rem - mm * nq);
    const int m = m0 + mm;
    uint32_t word = 0u;
    if (m < M) {
      const float* xr = x + (size_t)m * K + k;
      if (k + 3 < K && (((uintptr_t)xr) & 15) == 0) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr));
        word = (uint32_t)__float2int_rn(v.x) |
               ((uint32_t)__float2int_rn(v.y) << 8) |
               ((uint32_t)__float2int_rn(v.z) << 16) |
               ((uint32_t)__float2int_rn(v.w) << 24);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K)
            word |= (uint32_t)__float2int_rn(__ldg(xr + j)) << (8 * j);
      }
    }
    xq[idx] = (int)word;
  }
  __syncthreads();

  // the lane's output columns after the reduce-scatter
  const int off = ((slice & 1) ? VB / 2 : 0) + ((slice & 2) ? VB / 4 : 0) +
                  ((slice & 4) ? VB / 8 : 0);
  const int ccol = chunk * VB + off;                // column within the tile
  uint32_t hrc[MODE == kIdeal ? 1 : BM][MODE == kIdeal ? 1 : VO];
  if constexpr (MODE != kIdeal) {
    const uint32_t h0 = mix32(((uint32_t)__ldg(st.seed) ^ st.salt) ^ kGolden);
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) {
      const uint32_t hr = mix32(h0 ^ (uint32_t)(m0 + mm));
#pragma unroll
      for (int j = 0; j < VO; ++j)
        hrc[mm][j] = mix32(hr ^ (uint32_t)(n0 + ccol + j));
    }
  }

  const int q_step = kQuads * kSlices;
  for (int gl = wg; gl < ng; gl += wgs) {
    const int g = g0 + gl;
    const int* xg = xq + gl * tile;
    int acc[VB][BM];
#pragma unroll
    for (int c = 0; c < VB; ++c)
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) acc[c][mm] = 0;
    for (int p0 = slice; p0 < nq; p0 += q_step) {
      if (p0 != slice) load_quads(gl, p0);
#pragma unroll
      for (int i = 0; i < kQuads; ++i) {
        const int p = p0 + i * kSlices;
        if (p >= nq) break;
        int xw[BM];
#pragma unroll
        for (int mm = 0; mm < BM; ++mm) xw[mm] = xg[mm * nq + p];
#pragma unroll
        for (int q = 0; q < VB / 4; ++q) {
          int cw[4];
          quad_columns(wv[i][0][q], wv[i][1][q], cw);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int mm = 0; mm < BM; ++mm)
              acc[4 * q + j][mm] = __dp4a(cw[j], xw[mm], acc[4 * q + j][mm]);
        }
      }
    }
    if (gl + wgs < ng) load_quads(gl + wgs, slice);   // next group
    // reduce-scatter over the 8 slices (lane bits 2, 3, 4)
    reduce_half<VB / 2>(acc, slice & 1, 4);
    reduce_half<VB / 4>(acc, slice & 2, 8);
    reduce_half<VB / 8>(acc, slice & 4, 16);
    // TD-ADC transfer in registers
#pragma unroll
    for (int mm = 0; mm < BM; ++mm)
#pragma unroll
      for (int j = 0; j < VO; ++j) {
        const float part = (float)acc[j][mm];       // exact: < 2^24
        float v = __fmul_rn(part, inv_lsb);
        if constexpr (MODE == kFull) {
          const float cf =
              fminf(fmaxf(__fmul_rn(part, st.frac_scale), 0.f), 1.f);
          v = __fmaf_rn(part, inv_lsb, inl_curve(cf, st));
        }
        if constexpr (MODE != kIdeal) {
          const uint32_t base =
              mix32(hrc[mm][j] ^ ((uint32_t)g * 0x01000193u));
          v = __fmaf_rn(st.sigma, normal12(base), v);
        }
        float c = rintf(v);
        c = fminf(fmaxf(c, 0.f), code_max);
        cs[(gl * BM + mm) * nct + wc * NC + ccol + j] = c;
      }
  }
  cluster.sync();

  // digital partial-sum accumulation over the cluster, ascending group
  // order; the codes of a rank are fetched eight at a time before the
  // dependent chain of multiply-adds
  for (int e = rank * blockDim.x + threadIdx.x; e < BM * nct;
       e += n_rank * blockDim.x) {
    const int mm = e / nct;
    const int c = e - mm * nct;
    const int m = m0 + mm;
    const int n = blockIdx.x * nct + c;
    if (m >= M || n >= N) continue;
    float o = 0.f;
    for (int r = 0; r < n_rank; ++r) {
      const float* rc =
          (r == rank ? cs : cluster.map_shared_rank(cs, r)) + mm * nct + c;
      const int gn = min(gpc, G - r * gpc);
      for (int gb = 0; gb < gn; gb += 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = gb + i < gn ? rc[(gb + i) * BM * nct] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (gb + i < gn) o = __fmaf_rn(v[i], lsb, o);
      }
    }
    out[(size_t)m * N + n] = o;
  }
  cluster.sync();                 // peers may still read this CTA's codes
}

// The cluster launch of the packed kernel; returns -1 for shapes it does
// not take (groups of rows that are no multiple of four, or more shared
// memory than a CTA has): the caller then takes the fallback body. `kn`
// may set the cluster size and the column warps (0: the choice below); a
// tuned geometry whose codes do not fit in shared memory falls back to
// that choice.
template <int BM, int VB, int MODE, bool EXPERTS>
int launch_packed(const float* x, const uint8_t* w, float* out, int E, int M,
                  int N, int K, int KW, int n_rows, int G, float inv_lsb,
                  float lsb, float code_max, const Stochastic& st,
                  const Knobs& kn, cudaStream_t stream) {
  constexpr int NC = kChunks * VB;
  // Wide matrices: up to 8 warps side by side along the columns share one
  // CTA's staged activations. Then the groups split over just enough
  // cluster ranks to give the card ~kCtaTarget CTAs: the cluster barrier
  // and the DSMEM pass cost latency that only pays where the column tiles
  // alone would leave SMs idle. The remaining warps of a CTA (up to 8 in
  // all) take the rank's groups in turn. E experts (EXPERTS) multiply the
  // row tiles; a tile's N % VB == 0 keeps every expert's rows aligned.
  const long mt = (long)((M + BM - 1) / BM) * E;   // (expert, row) tiles
  if (mt > 65535) return (int)cudaErrorInvalidValue;
  const long warp_tiles = (long)((N + NC - 1) / NC) * mt;
  int wcols, cs, gpc;
  size_t smem;
  auto plan = [&](int want_cs, int want_wc) {
    wcols = want_wc;
    if (wcols == 0) {
      wcols = 1;
      while (wcols < kGroupWarps && warp_tiles >= 2L * wcols * kWideTiles)
        wcols *= 2;
    }
    const long tiles = (long)((N + wcols * NC - 1) / (wcols * NC)) * mt;
    cs = want_cs;
    if (cs == 0) {
      cs = 1;
      while (cs < kMaxCluster && cs * tiles < kCtaTarget) cs *= 2;
    }
    if (cs > G) cs = G;
    gpc = (G + cs - 1) / cs;
    cs = (G + gpc - 1) / gpc;               // no rank without a group
    smem = sizeof(float) * (size_t)gpc * BM * (n_rows / 4 + wcols * NC);
  };
  plan(kn.cluster, kn.wcols);
  if (smem > kSmemMax && (kn.cluster || kn.wcols)) plan(0, 0);
  if (smem > kSmemMax || n_rows % 4) return -1;
  kn.report(cs, wcols);
  int wgs = kGroupWarps / wcols;
  if (wgs > gpc) wgs = gpc;
  static size_t cap = 48 * 1024;   // raised once per instantiation and size
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        cim_mvm_packed_kernel<BM, VB, MODE, EXPERTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  const int vec = (N % VB == 0) && ((uintptr_t)w % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + wcols * NC - 1) / (wcols * NC), cs, (int)mt);
  cfg.blockDim = dim3(wgs * wcols * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, cim_mvm_packed_kernel<BM, VB, MODE, EXPERTS>,
                         x, w, out, M, N, K, KW, n_rows, G, gpc, wcols, vec,
                         inv_lsb, lsb, code_max, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- B2 / B5: the dense kernel, group axis split over a cluster --------
//
// A warp owns 4 * C output columns x BM rows (C float4 chunks: lane % C is
// the chunk, lane / C = S the row slice, S = 32 / C); a CTA holds `wcols`
// such warps side by side and `wgs` rows of them that take the groups of a
// pass in turn; the cluster's CTAs (grid y, cluster dims (1, CS, 1)) own
// `gpc` consecutive groups each. The activation codes of a pass's groups
// are staged in shared memory as [group][row][BM] (a row's BM values side
// by side) by 4-byte cp.async copies, all in flight at once. For each of
// its groups a lane loads a float4 (its chunk's 4 columns) of the rows
// slice, slice + S, ..., U of them at once, and multiplies each with the
// row's BM activation codes (one or two 16-byte shared loads) in f32 FMAs.
// The S slices are summed by a reduce-scatter over the lanes (two steps
// over the columns, and at S = 8 one over the rows; exact integers), which
// leaves each lane one column x BM * 4 / S rows of group sums; the ADC
// converts them in registers (at NOISY/FULL with noise drawn before the
// group's MAC, while its rows are in flight) and the codes go to this
// CTA's shared memory. After cluster.sync() every CTA finalises a slice of
// the tile's outputs, reading every group's code through distributed
// shared memory in ascending group order, one __fmaf_rn(code, lsb, o) per
// group.
//
// Without a cluster the groups may be staged in passes of `gpp` (each
// pass's codes added to the outputs before the next), and a lone group's
// rows in windows of `rpp` (its sums kept in registers across windows);
// with a cluster the host guarantees one pass and one window.
//
// C = 4 (S = 8) at BM = 4, C = 8 (S = 4) at BM = 8: each measured the
// faster at its tile height on the H100.
__host__ __device__ constexpr int dense_chunks(int bm) {
  return bm == 4 ? 4 : 8;
}
constexpr int kDenseWarps = 8;        // warps per CTA at most
constexpr long kDenseWarpTarget = 2048;  // warps the split aims for
constexpr int kDenseWideTiles = 256;  // CTA tiles left after widening

// Four columns of one f32 weight row: a 16-byte load where `vec` (N % 4 ==
// 0 and w 16-byte aligned), else scalar loads of the columns left; zeros
// past N (and for rows the caller masks with cols_left = 0).
__device__ __forceinline__ float4 load_cols(const float* __restrict__ w,
                                            size_t off, int cols_left,
                                            bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cols_left <= 0) return v;
  if (vec) return __ldg(reinterpret_cast<const float4*>(w + off));
  v.x = __ldg(w + off);
  if (cols_left > 1) v.y = __ldg(w + off + 1);
  if (cols_left > 2) v.z = __ldg(w + off + 2);
  if (cols_left > 3) v.w = __ldg(w + off + 3);
  return v;
}

// A 4-byte asynchronous copy from global to shared memory, zero-filled
// where !ok (no bytes are read then).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One step of the dense reduce-scatter: lanes `mask` apart swap halves of
// their first 2W columns; the lane with `upper` set keeps the upper half.
template <int W, int BM>
__device__ __forceinline__ void reduce_cols(float (&acc)[4][BM], int upper,
                                            int mask) {
#pragma unroll
  for (int c = 0; c < W; ++c)
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) {
      const float send = upper ? acc[c][mm] : acc[c + W][mm];
      const float keep = upper ? acc[c + W][mm] : acc[c][mm];
      acc[c][mm] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

template <int BM, int MODE, bool EXPERTS>
__global__ void __launch_bounds__(kDenseWarps * 32, 2)
cim_mvm_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int M, int N, int K,
                     int n_rows, int G, int gpc, int gpp, int rpp, int wcols,
                     int vec, float inv_lsb, float lsb, float code_max,
                     Stochastic st) {
  constexpr int kChunks = dense_chunks(BM);
  constexpr int kCols = 4 * kChunks;                // columns per warp
  constexpr int kSlices = 32 / kChunks;             // row slices per group
  constexpr int U = 9;                              // rows a lane loads
  constexpr int HB = kSlices == 8 ? BM / 2 : BM;    // its rows of outputs
  extern __shared__ float smem[];
  const int nct = wcols * kCols;                    // columns per CTA
  float* xs = smem;                                 // [gpp][rpp][BM]
  float* cs = smem + (size_t)gpp * rpp * BM;        // [gpp][BM][nct] codes
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_rank = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wc = warp % wcols;                      // the warp's column tile
  const int wg = warp / wcols;                      // ... and group lane
  const int wgs = (blockDim.x >> 5) / wcols;
  const int n0 = blockIdx.x * nct + wc * kCols;
  int mz = blockIdx.z;                              // the row tile
  if constexpr (EXPERTS) {
    // grid z runs over (expert, row tile); the expert's operands are the
    // next [M, K], [K, N] and [M, N] blocks
    const int mt = (M + BM - 1) / BM;
    const int e = mz / mt;
    mz -= e * mt;
    x += (size_t)e * M * K;
    w += (size_t)e * K * N;
    out += (size_t)e * M * N;
  }
  const int m0 = mz * BM;
  const int g0 = rank * gpc;
  const int ng = max(0, min(gpc, G - g0));
  const int chunk = lane % kChunks;
  const int slice = lane / kChunks;
  const int col = n0 + 4 * chunk;                   // first column loaded

  float4 wv[U];
  // rows rb, rb + kSlices, ... (U of them, those below rend) of group g
  auto load_rows = [&](int g, int rb, int rend) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = rb + i * kSlices;
      const int row = g * n_rows + r;
      const bool ok = r < rend && row < K;
      wv[i] = load_cols(w, (size_t)row * N + col, ok ? N - col : 0, vec);
    }
  };
  // the first rows of the warp's first group: issued before anything waits
  bool pre = false;
  if (wg < min(gpp, ng)) {
    load_rows(g0 + wg, slice, min(rpp, n_rows));
    pre = true;
  }

  // the lane's column and rows after the reduce-scatter
  const int cc = 4 * chunk + ((slice & 1) ? 2 : 0) + ((slice & 2) ? 1 : 0);
  const int mh = (kSlices == 8 && (slice & 4)) ? HB : 0;
  uint32_t hrc[MODE == kIdeal ? 1 : HB];
  if constexpr (MODE != kIdeal) {
    const uint32_t h0 = mix32(((uint32_t)__ldg(st.seed) ^ st.salt) ^ kGolden);
#pragma unroll
    for (int j = 0; j < HB; ++j)
      hrc[j] =
          mix32(mix32(h0 ^ (uint32_t)(m0 + mh + j)) ^ (uint32_t)(n0 + cc));
  }

  float acc[4][BM];
  float o[HB];                        // the outputs this thread finalises
#pragma unroll
  for (int i = 0; i < HB; ++i) o[i] = 0.f;
  for (int p0 = 0; p0 < gpc; p0 += gpp) {
    const int np = max(0, min(gpp, ng - p0));      // this pass's groups
    for (int r0 = 0; r0 < n_rows; r0 += rpp) {
      const int rend = min(r0 + rpp, n_rows);
      const int rw = rend - r0;
      if (p0 | r0) __syncthreads();   // the last pass is done with xs, cs
      // the pass's activation codes (zero past M and K): its rows are the
      // `len` consecutive k from k0 (one window, or whole groups), staged
      // as [k - k0][BM] by asynchronous copies that are all in flight at
      // once
      const int k0 = (g0 + p0) * n_rows + r0;
      const int len = np * rw;
      for (int idx = threadIdx.x; idx < len * BM; idx += blockDim.x) {
        const int mm = idx / len;
        const int i = idx - mm * len;
        const int m = m0 + mm;
        const bool ok = m < M && k0 + i < K;
        cp_async4(xs + i * BM + mm, ok ? x + (size_t)m * K + k0 + i : x, ok);
      }
      cp_async_wait_all();
      __syncthreads();

      for (int gl = wg; gl < np; gl += wgs) {
        const int g = g0 + p0 + gl;
        if (r0 == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int mm = 0; mm < BM; ++mm) acc[c][mm] = 0.f;
        }
        // the group's noise draws depend on no data: drawn while its
        // first rows are in flight
        float nz[MODE == kIdeal ? 1 : HB];
        if constexpr (MODE != kIdeal) {
          if (rend == n_rows) {
#pragma unroll
            for (int j = 0; j < HB; ++j)
              nz[j] = normal12(mix32(hrc[j] ^ ((uint32_t)g * 0x01000193u)));
          }
        }
        const float* xg = xs + (size_t)gl * rw * BM;
        for (int rb = r0 + slice; rb < rend; rb += U * kSlices) {
          if (!pre) load_rows(g, rb, rend);
          pre = false;
#pragma unroll
          for (int i = 0; i < U; ++i) {
            const int r = rb + i * kSlices;
            if (r >= rend) break;
            float xv[BM];
#pragma unroll
            for (int q = 0; q < BM / 4; ++q) {
              const float4 t =
                  *reinterpret_cast<const float4*>(xg + (r - r0) * BM + 4 * q);
              xv[4 * q] = t.x; xv[4 * q + 1] = t.y;
              xv[4 * q + 2] = t.z; xv[4 * q + 3] = t.w;
            }
#pragma unroll
            for (int mm = 0; mm < BM; ++mm) {
              acc[0][mm] = fmaf(wv[i].x, xv[mm], acc[0][mm]);
              acc[1][mm] = fmaf(wv[i].y, xv[mm], acc[1][mm]);
              acc[2][mm] = fmaf(wv[i].z, xv[mm], acc[2][mm]);
              acc[3][mm] = fmaf(wv[i].w, xv[mm], acc[3][mm]);
            }
          }
        }
        pre = false;                  // a lane with no rows here left it unused
        if (gl + wgs < np) {          // the next group's first rows
          load_rows(g + wgs, r0 + slice, rend);
          pre = true;
        }
        if (rend < n_rows) continue;  // the group's sums are not complete
        // reduce-scatter over the slices (the lane bits above the chunk)
        reduce_cols<2, BM>(acc, slice & 1, kChunks);
        reduce_cols<1, BM>(acc, slice & 2, 2 * kChunks);
        if constexpr (kSlices == 8) {
#pragma unroll
          for (int j = 0; j < HB; ++j) {
            const float send = (slice & 4) ? acc[0][j] : acc[0][j + HB];
            const float keep = (slice & 4) ? acc[0][j + HB] : acc[0][j];
            acc[0][j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
        }
        // TD-ADC transfer in registers
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          const float part = acc[0][j];             // exact: < 2^24
          float v = __fmul_rn(part, inv_lsb);
          if constexpr (MODE == kFull) {
            const float cf =
                fminf(fmaxf(__fmul_rn(part, st.frac_scale), 0.f), 1.f);
            v = __fmaf_rn(part, inv_lsb, inl_curve(cf, st));
          }
          if constexpr (MODE != kIdeal) v = __fmaf_rn(st.sigma, nz[j], v);
          float c = rintf(v);
          c = fminf(fmaxf(c, 0.f), code_max);
          cs[(gl * BM + mh + j) * nct + wc * kCols + cc] = c;
        }
      }
    }
    if (n_rank > 1) cluster.sync(); else __syncthreads();

    // digital partial-sum accumulation over the cluster (or this pass),
    // ascending group order; the codes of a rank are fetched eight at a
    // time before the dependent chain of multiply-adds
#pragma unroll
    for (int i = 0; i < HB; ++i) {
      const int e = (rank + i * n_rank) * blockDim.x + threadIdx.x;
      if (e >= BM * nct) continue;
      const int mm = e / nct;
      const int c = e - mm * nct;
      float oi = o[i];
      for (int r = 0; r < n_rank; ++r) {
        const float* rc =
            (r == rank ? cs : cluster.map_shared_rank(cs, r)) + mm * nct + c;
        const int gn = max(0, min(gpp, min(gpc, G - r * gpc) - p0));
        for (int gb = 0; gb < gn; gb += 8) {
          float v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = gb + q < gn ? rc[(gb + q) * BM * nct] : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (gb + q < gn) oi = __fmaf_rn(v[q], lsb, oi);
        }
      }
      o[i] = oi;
    }
  }
  if (n_rank > 1) cluster.sync();     // peers may still read this CTA's codes

#pragma unroll
  for (int i = 0; i < HB; ++i) {
    const int e = (rank + i * n_rank) * blockDim.x + threadIdx.x;
    if (e >= BM * nct) continue;
    const int mm = e / nct;
    const int m = m0 + mm;
    const int n = blockIdx.x * nct + e - mm * nct;
    if (m < M && n < N) out[(size_t)m * N + n] = o[i];
  }
}

// The cluster launch of the dense kernel; takes every shape. `kn` may set
// the cluster size asked for and the column warps (0: the choice below);
// a tuned cluster whose codes do not fit in shared memory takes more
// ranks.
template <int BM, int MODE, bool EXPERTS>
int launch_dense(const float* x, const float* w, float* out, int E, int M,
                 int N, int K, int n_rows, int G, float inv_lsb, float lsb,
                 float code_max, const Stochastic& st, const Knobs& kn,
                 cudaStream_t stream) {
  // Wide matrices: up to 8 warps side by side along the columns share one
  // CTA's staged activations. Then the groups split over the fewest
  // cluster ranks that give the most warps, up to ~kDenseWarpTarget (two
  // 8-warp CTAs per SM): each rank more costs barrier and DSMEM latency.
  // E experts (EXPERTS) multiply the row tiles.
  constexpr int kCols = 4 * dense_chunks(BM);       // columns per warp
  const long mt = (long)((M + BM - 1) / BM) * E;   // (expert, row) tiles
  if (mt > 65535) return (int)cudaErrorInvalidValue;
  const long warp_tiles = (long)((N + kCols - 1) / kCols) * mt;
  int wcols = kn.wcols;
  if (wcols == 0) {
    wcols = 1;
    while (wcols < kDenseWarps && warp_tiles >= 2L * wcols * kDenseWideTiles)
      wcols *= 2;
  }
  const int nct = wcols * kCols;
  const long tiles = (long)((N + nct - 1) / nct) * mt;
  int req = 1;                              // cluster size asked for
  int cs, gpc;
  auto split = [&]() {
    gpc = (G + std::min(req, G) - 1) / std::min(req, G);
    cs = (G + gpc - 1) / gpc;               // no rank without a group
  };
  auto warps = [&]() {
    return tiles * cs * wcols * std::min(kDenseWarps / wcols, gpc);
  };
  auto smem_of = [&](long groups, long rows) {
    return sizeof(float) * (size_t)groups * BM * (rows + nct);
  };
  if (kn.cluster) {
    req = kn.cluster;
    split();
    while (smem_of(gpc, n_rows) > kSmemMax && req < kMaxCluster) {
      req *= 2;
      split();
    }
  } else {
    split();
    long most = warps();
    for (int r = 2; r <= kMaxCluster && most < kDenseWarpTarget; r *= 2) {
      const int keep = req;
      req = r;
      split();
      if (warps() > most) {
        most = warps();
      } else {
        req = keep;
        split();
      }
    }
    // fewer groups per rank where a rank's would keep two CTAs from
    // sharing an SM (or do not fit at all)
    while (smem_of(gpc, n_rows) > kSmemMax / 2 && req < kMaxCluster) {
      req *= 2;
      split();
    }
  }
  int gpp = gpc, rpp = n_rows;
  if (smem_of(gpc, n_rows) > kSmemMax) {
    // a rank's codes must stay resident until its peers have read them:
    // where they do not fit even over 8 ranks, no cluster, and the groups
    // go in passes (or a lone group's rows in windows)
    cs = 1;
    gpc = G;
    gpp = (int)std::min<size_t>(G, kSmemMax / smem_of(1, n_rows));
    if (gpp < 1) {
      gpp = 1;
      rpp = (int)(kSmemMax / (sizeof(float) * BM)) - nct;
    }
  }
  kn.report(cs, wcols);
  const int wgs = std::min(kDenseWarps / wcols, gpp);
  const size_t smem = smem_of(gpp, rpp);
  static size_t cap = 48 * 1024;   // raised once per instantiation and size
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        cim_mvm_dense_kernel<BM, MODE, EXPERTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  const int vec = (N % 4 == 0) && ((uintptr_t)w % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + nct - 1) / nct, cs, (int)mt);
  cfg.blockDim = dim3(wgs * wcols * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, cim_mvm_dense_kernel<BM, MODE, EXPERTS>, x, w, out, M, N, K,
      n_rows, G, gpc, gpp, rpp, wcols, vec, inv_lsb, lsb, code_max, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool PACKED, int MODE, bool EXPERTS>
int dispatch_rows(const float* x, const void* w, float* out, int E, int M,
                  int N, int K, int KW, int n_rows, int G, float inv_lsb,
                  float lsb, float code_max, const Stochastic& st,
                  const Knobs& kn, cudaStream_t stream) {
  if constexpr (!PACKED) {
    const float* wf = static_cast<const float*>(w);
    return M <= 4 ? launch_dense<4, MODE, EXPERTS>(x, wf, out, E, M, N, K,
                                                   n_rows, G, inv_lsb, lsb,
                                                   code_max, st, kn, stream)
                  : launch_dense<8, MODE, EXPERTS>(x, wf, out, E, M, N, K,
                                                   n_rows, G, inv_lsb, lsb,
                                                   code_max, st, kn, stream);
  } else {
    const uint8_t* wp = static_cast<const uint8_t*>(w);
    const int rc =
        M <= 4 ? launch_packed<4, 16, MODE, EXPERTS>(x, wp, out, E, M, N, K,
                                                     KW, n_rows, G, inv_lsb,
                                                     lsb, code_max, st, kn,
                                                     stream)
               : launch_packed<8, 8, MODE, EXPERTS>(x, wp, out, E, M, N, K,
                                                    KW, n_rows, G, inv_lsb,
                                                    lsb, code_max, st, kn,
                                                    stream);
    if (rc != -1) return rc;
    return M <= 4 ? launch_fallback<4, MODE, EXPERTS>(
                        x, wp, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb,
                        code_max, st, stream)
                  : launch_fallback<8, MODE, EXPERTS>(
                        x, wp, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb,
                        code_max, st, stream);
  }
}

// E > 1 problems side by side (EXPERTS): x [E, M, K], w [E, KW, N], out
// [E, M, N], each expert computed as its own 2-D launch would.
template <bool PACKED, bool EXPERTS = false>
int dispatch(const float* x, const void* w, float* out, int E, int M, int N,
             int K, int KW, int n_rows, int G, float inv_lsb, float lsb,
             float code_max, int mode, const Stochastic& st, const Knobs& kn,
             cudaStream_t stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  switch (mode) {
    case kIdeal:
      return dispatch_rows<PACKED, kIdeal, EXPERTS>(
          x, w, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st,
          kn, stream);
    case kNoisy:
      return dispatch_rows<PACKED, kNoisy, EXPERTS>(
          x, w, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st,
          kn, stream);
    case kFull:
      return dispatch_rows<PACKED, kFull, EXPERTS>(
          x, w, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st,
          kn, stream);
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

// The knobs as a launcher takes them: a cluster of at most kMaxCluster,
// column warps a power of two up to kGroupWarps (the largest not above
// the value asked for); negative values mean 0, the launcher's choice.
Knobs make_knobs(int cluster, int wcols, int* used) {
  cluster = cluster < 0 ? 0 : std::min(cluster, kMaxCluster);
  int wc = 0;
  if (wcols > 0) {
    wc = 1;
    while (wc * 2 <= std::min(wcols, kGroupWarps)) wc *= 2;
  }
  Knobs kn{cluster, wc, used};
  kn.report(0, 0);
  return kn;
}

}  // namespace

extern "C" {

// Every entry point takes the tuning knobs `cluster` and `wcols` (0: the
// launcher's own choice; see Knobs) and `used`, null or a host int[2]
// that receives the cluster size and the column warps launched.

// B2: x [M, K] f32, w [K, N] f32 codes, out [M, N] f32.
int cim_mvm_dense_launch(const float* x, const float* w, float* out, int M,
                         int N, int K, int n_rows, float inv_lsb, float lsb,
                         float code_max, int cluster, int wcols, int* used,
                         cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  const Stochastic none{};
  return dispatch<false>(x, w, out, 1, M, N, K, K, n_rows, groups(K, n_rows),
                         inv_lsb, lsb, code_max, kIdeal, none, kn, stream);
}

// B1: x [M, K] f32, w [K2, N] uint8 nibble pairs (K <= 2 K2), out [M, N] f32.
int cim_mvm_packed_launch(const float* x, const uint8_t* w, float* out,
                          int M, int N, int K, int K2, int n_rows,
                          float inv_lsb, float lsb, float code_max,
                          int cluster, int wcols, int* used,
                          cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  const Stochastic none{};
  return dispatch<true>(x, w, out, 1, M, N, K, K2, n_rows,
                        groups(2 * K2, n_rows), inv_lsb, lsb, code_max, kIdeal,
                        none, kn, stream);
}

// B5: B2 with the stochastic converter; mode 1 = NOISY, 2 = FULL; seed is a
// 1-element int32 device tensor.
int cim_mvm_noisy_dense_launch(const float* x, const float* w, float* out,
                               int M, int N, int K, int n_rows,
                               float inv_lsb, float lsb, float code_max,
                               int mode, const int* seed, unsigned salt,
                               float sigma, const float* inl,
                               int cluster, int wcols, int* used,
                               cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<false>(x, w, out, 1, M, N, K, K, n_rows, groups(K, n_rows),
                         inv_lsb, lsb, code_max, mode, st, kn, stream);
}

// B6: B1 with the stochastic converter (bit-identical to B5).
int cim_mvm_noisy_packed_launch(const float* x, const uint8_t* w, float* out,
                                int M, int N, int K, int K2, int n_rows,
                                float inv_lsb, float lsb, float code_max,
                                int mode, const int* seed, unsigned salt,
                                float sigma, const float* inl,
                                int cluster, int wcols, int* used,
                                cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<true>(x, w, out, 1, M, N, K, K2, n_rows,
                        groups(2 * K2, n_rows), inv_lsb, lsb, code_max, mode,
                        st, kn, stream);
}

// B2, expert-batched: x [E, M, K] f32, w [E, K, N] f32 codes, out [E, M,
// N] f32; expert e computes what B2 computes on x[e], w[e] (one launch, its
// own template instances).
int cim_mvm_dense_experts_launch(const float* x, const float* w, float* out,
                                 int E, int M, int N, int K, int n_rows,
                                 float inv_lsb, float lsb, float code_max,
                                 int cluster, int wcols, int* used,
                                 cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  const Stochastic none{};
  return dispatch<false, true>(x, w, out, E, M, N, K, K, n_rows,
                               groups(K, n_rows), inv_lsb, lsb, code_max,
                               kIdeal, none, kn, stream);
}

// B5, expert-batched. The counter hash takes the row within the expert and
// no expert index, so every expert draws the noise B5 draws on its own.
int cim_mvm_noisy_dense_experts_launch(const float* x, const float* w,
                                       float* out, int E, int M, int N,
                                       int K, int n_rows, float inv_lsb,
                                       float lsb, float code_max, int mode,
                                       const int* seed, unsigned salt,
                                       float sigma, const float* inl,
                                       int cluster, int wcols, int* used,
                                       cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<false, true>(x, w, out, E, M, N, K, K, n_rows,
                               groups(K, n_rows), inv_lsb, lsb, code_max,
                               mode, st, kn, stream);
}

// B1, expert-batched: x [E, M, K] f32, w [E, K2, N] uint8, out [E, M, N]
// f32; expert e computes what B1 computes on x[e], w[e] (one launch, its
// own template instances).
int cim_mvm_packed_experts_launch(const float* x, const uint8_t* w,
                                  float* out, int E, int M, int N, int K,
                                  int K2, int n_rows, float inv_lsb,
                                  float lsb, float code_max,
                                  int cluster, int wcols, int* used,
                                  cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  const Stochastic none{};
  return dispatch<true, true>(x, w, out, E, M, N, K, K2, n_rows,
                              groups(2 * K2, n_rows), inv_lsb, lsb, code_max,
                              kIdeal, none, kn, stream);
}

// B6, expert-batched. The counter hash takes the row within the expert and
// no expert index, so every expert draws the noise B6 draws on its own.
int cim_mvm_noisy_packed_experts_launch(const float* x, const uint8_t* w,
                                        float* out, int E, int M, int N,
                                        int K, int K2, int n_rows,
                                        float inv_lsb, float lsb,
                                        float code_max, int mode,
                                        const int* seed, unsigned salt,
                                        float sigma, const float* inl,
                                        int cluster, int wcols, int* used,
                                        cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<true, true>(x, w, out, E, M, N, K, K2, n_rows,
                              groups(2 * K2, n_rows), inv_lsb, lsb, code_max,
                              mode, st, kn, stream);
}

}  // extern "C"
