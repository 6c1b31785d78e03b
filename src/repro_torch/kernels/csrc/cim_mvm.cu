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
// Expert-batched (the MoE routed experts, which the reference runs as
// jax.vmap of its kernels): x [E, M, K], w [E, K2, N] (or dense [E, K, N])
// -> out [E, M, N] in one launch. Rows and groups are counted within an
// expert, so an expert's outputs, and under NOISY/FULL its noise draws,
// are those of a 2-D launch on its own operands.
//
// B1e/B6e (cim_mvm_packed_experts_kernel) have a body of their own. What
// bounds them on this card: at qwen2-moe's decode (64 experts of capacity
// 8, K 2048 <-> 1408) a projection streams 92 MB of codes for 8 rows, a
// bytes bound of ~28 us; the __dp4a route costs ~100 integer instructions
// per 16 weight bytes (the nibble unpack, 8 x 8 dp4a, the activation
// loads), as long again at full issue, and B6e adds the counter hash
// (~1.3 G int32 operations a projection). The 2-D body over grid z ran at
// 0.66 TB/s: 153-163 registers and a 123 KB code buffer held one 8-warp
// CTA an SM, a warp had 2.5 KB of weights in flight, the next group's
// loads waited for the current group's dp4a, and every CTA converted its
// expert's activations in a loop of dependent loads. The new body does
// the group's MAC on the tensor cores (an m16n8k16 s8 MMA with the 8
// activation rows as its N: exact integer sums; a __dp4a variant with the
// same loads took 1.7x as long), streams weights and activations through
// a cp.async ring per warp, converts the codes in registers and adds them
// to outputs the warp owns across all its groups (no code buffer, no
// cluster), splits groups over warps only where that balances the SMs,
// and walks a persistent grid. It reaches ~1.6 TB/s: the ring's depth (4
// to 16 k-steps) moved nothing, and an L2 prefetch of whole rows or an
// activation ring shared by a CTA's warps was slower, so what is left is
// most likely the DRAM efficiency of 64-byte row pieces (not profiled:
// ncu is refused on the machine).
//
// B2e/B5e (cim_mvm_dense_experts_kernel) have a body of their own, B1e's
// design over f32 weights. What bounds them on this card: the f32 codes
// (4 bytes a weight): at qwen2-moe's training capacity (64 experts of 40
// rows, K 2048 <-> 1408) a layer's three MVMs read 2.21 GB, ~0.69 ms, and
// at deepseek-v3's decode (256 experts of 8 rows) 45.1 GB, ~13.5 ms; B5e
// adds the counter hash (at C = 40 ~19 G int32 operations a layer, ~1.1
// ms). The dense kernel's EXPERTS instances (grid z over (expert, 8-row
// tile), f32 FMAs) read each expert's weights once per 8 rows, 5 times at
// C = 40. The new body reads them once for up to 40 rows (a tile of 8 rows
// for M <= 8, of 40 above): the weights and activations stream through a
// cp.async ring per warp, each lane converts its f32 codes to u8 once in
// registers, and a u8 m16n8k16 MMA forms the group sums (exact s32); the
// ADC runs in registers and the digital sum stays in the lane's registers
// across its groups, on a persistent grid. It takes codes of at most 8
// bits (the MacroConfig's widths, which the caller states) in groups of a
// multiple of four rows; every other launch keeps the dense kernel's body.
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
// The dense kernel also takes B2e/B5e's launches that their own body does
// not (EXPERTS = true: grid z over (expert, row tile)).
//
// cim_mvm_kernel, the first design's body (one block per 32 columns, 16
// warps over up to 16 groups at a time), is kept only for B1/B6 where the
// packed kernel cannot take the shape: groups of rows that are no multiple
// of four (an int8x4 word would straddle two groups), or more shared
// memory than a CTA has. It stages fewer groups per pass where 16 do not
// fit. Later work: B1e's MMA and weight ring for the 2-D B1/B6 and for
// prefill-sized M (ROADMAP speed item 4).

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

template <int BM, int VB, int MODE>
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
  const int m0 = blockIdx.z * BM;                   // the row tile
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
template <int BM, int VB, int MODE>
int launch_packed(const float* x, const uint8_t* w, float* out, int M, int N,
                  int K, int KW, int n_rows, int G, float inv_lsb, float lsb,
                  float code_max, const Stochastic& st, const Knobs& kn,
                  cudaStream_t stream) {
  constexpr int NC = kChunks * VB;
  // Wide matrices: up to 8 warps side by side along the columns share one
  // CTA's staged activations. Then the groups split over just enough
  // cluster ranks to give the card ~kCtaTarget CTAs: the cluster barrier
  // and the DSMEM pass cost latency that only pays where the column tiles
  // alone would leave SMs idle. The remaining warps of a CTA (up to 8 in
  // all) take the rank's groups in turn.
  const long mt = (M + BM - 1) / BM;               // row tiles
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
        cim_mvm_packed_kernel<BM, VB, MODE>,
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
      cudaLaunchKernelEx(&cfg, cim_mvm_packed_kernel<BM, VB, MODE>,
                         x, w, out, M, N, K, KW, n_rows, G, gpc, wcols, vec,
                         inv_lsb, lsb, code_max, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

// ---- B1e / B6e: the expert-batched packed kernel --------------------------
//
// x [E, M, K] f32 codes, w [E, KW, N] nibble pairs -> out [E, M, N]. A
// warp's unit of work is (expert, 8-row tile, 64-column tile) and, where
// that balances the SMs better, a slice of the groups (`gs` slices; the
// launcher's choice). A CTA holds kExpWarps warps: wc = kExpWarps / gs
// column tiles of one (expert, row tile) item, times the gs slices. A
// step is (item, block of wc column tiles); the grid is persistent:
// min(steps, SMs x CTAs an SM holds) CTAs, each taking a contiguous run
// of the steps in expert-major order.
//
// Lane (g8 = lane / 4, t = lane % 4) of a warp takes, for k-step s of a
// group (16 weight rows), chunk c = 4 s + t (4 weight rows: byte rows 2c
// and 2c + 1) of columns 8 g8 .. 8 g8 + 7, and activation row g8's 4 f32
// codes of the same chunk. Both arrive by cp.async copies in a
// shared-memory ring of kExpRing k-steps per warp, kExpRing - 1 in flight
// across group ends (the next group's rows arrive while this group's ADC
// runs); a cp.async.wait_group and a __syncwarp are the ring's only
// synchronisation, and the activations need no staging pass (a CTA-wide
// staging, even with every copy in flight, stalled each CTA for a loaded
// memory latency: ~60 us of a layer's 217). The nibbles become one
// int8x4 word per column (its 4 rows); columns 8 g8 + 2q and 8 g8 + 2q +
// 1 are the A rows g8 and g8 + 8 of the q-th m16n8k16 integer MMA, whose
// B is the lane's 4 activation codes as an int8x4 word (an exact s32 sum:
// the codes are < 16). The lane's 16 group sums (2 columns x 2 rows of
// each of the 4 MMA tiles) are converted in registers and code * lsb is
// added to the lane's outputs as one __fmaf_rn per group, in ascending
// group order: the warp walks its groups in order, so no code leaves the
// registers. Split groups (gs > 1) park their codes in shared memory, and
// after a barrier the CTA sums every group's code per output in ascending
// order.
constexpr int kExpWarps = 4;          // warps per CTA
constexpr int kExpCols = 64;          // columns per warp tile
constexpr int kExpRows = 8;           // activation rows per tile (MMA n)
constexpr int kExpRing = 8;           // k-steps in the ring of a warp
constexpr int kExpCtas = 4;           // CTAs an SM holds (128 registers)
constexpr int kExpVals = 16;          // outputs a lane converts per group
constexpr int kExpWBytes = 8 * kExpCols;    // weight bytes of a k-step
constexpr int kExpStep = kExpWBytes + 32 * 16;   // ... and its activations

// c (16 x 8, s32) += a (16 x 16, s8, rows g8 and g8 + 8) * b (16 x 8, s8)
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// 16- and 8-byte asynchronous copies from global to shared memory (the
// 16-byte one past L1) of the first `bytes` of src, zero-filled beyond.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The column and the row within the unit of a lane's output v: MMA tile
// v / 4, its accumulator v % 4.
__device__ __forceinline__ int exp_col(int v, int g8) {
  return 8 * g8 + 2 * (v >> 2) + ((v >> 1) & 1);
}
__device__ __forceinline__ int exp_row(int v, int t) {
  return 2 * t + (v & 1);
}

// Byte row r (0..7) of a k-step's 64-byte rows in a ring slot: rows r and
// r + 2 land in opposite halves of the 32 banks, so the 8-byte reads of a
// warp's lanes (rows 2t + h) take the two wavefronts their 256 bytes need.
__device__ __forceinline__ int exp_row_at(int r) {
  return (r ^ ((r >> 1) & 1)) * kExpCols;
}

// k-steps of group grp: its byte rows below KW, two a chunk, four chunks
// a k-step (the last group of a K that is no multiple of n_rows has fewer)
__device__ __forceinline__ int exp_ksteps(int grp, int nq, int half,
                                          int KW) {
  return (min(nq, (KW - grp * half + 1) >> 1) + 3) >> 2;
}

// Four f32 codes (integers below 2^22) as an int8x4 word, lowest first:
// adding 1.5 * 2^23 rounds each to nearest even (__float2int_rn) into the
// low mantissa bits, and three byte permutes gather the low bytes.
__device__ __forceinline__ int exp_pack(float4 v) {
  const float m = 12582912.f;
  const uint32_t a = __float_as_uint(__fadd_rn(v.x, m));
  const uint32_t b = __float_as_uint(__fadd_rn(v.y, m));
  const uint32_t c = __float_as_uint(__fadd_rn(v.z, m));
  const uint32_t d = __float_as_uint(__fadd_rn(v.w, m));
  return (int)__byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                          0x5410);
}

// The producer side of a warp's ring: k-step pj (k-step ps of group pg)
// of the warp's n_ks into slot pj % kExpRing, then one commit group (an
// empty one past the last k-step, so that the consumer's wait counts stay
// the same). Weights: with 16-byte copies lane l copies 16 bytes of byte
// row l / 4; with 8-byte ones (rows only 8-byte aligned) its own 8
// columns of its two rows; rows not 8-byte aligned are loaded and stored.
// Activations: lane (g8, t) copies row m0 + g8's 4 codes of chunk 4 ps + t
// (zero past M and K; 4-byte copies where the rows are not 16-byte
// aligned).
__device__ __forceinline__ void exp_produce(uint8_t* slots,
                                            const uint8_t* __restrict__ we,
                                            const float* __restrict__ xr,
                                            bool row_ok, int N, int K,
                                            int KW, int nq, int half,
                                            int kfull, int n0, int lane,
                                            int n_ks, int vec, int vec_x,
                                            int& pj, int& pg, int& ps) {
  static_assert((kExpRing & (kExpRing - 1)) == 0, "a power of two");
  uint8_t* slot = slots + (pj & (kExpRing - 1)) * kExpStep;
  if (pj < n_ks) {
    {
      const int c = 4 * ps + (lane & 3);
      const int k = pg * 4 * nq + 4 * c;           // the chunk's first k
      const int left = row_ok && c < nq ? K - k : 0;
      float* d = reinterpret_cast<float*>(slot + kExpWBytes + 16 * lane);
      if (vec_x) {
        cp_async16(d, left > 0 ? xr + k : xr, left > 0 ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          cp_async4(d + u, left > u ? xr + k + u : xr, left > u);
      }
    }
    const int row0 = pg * half + 8 * ps;            // the k-step's byte rows
    const int rows = min(min(8, 2 * nq - 8 * ps), KW - row0);
    if (vec == 16) {
      const int r = lane >> 2, q = 16 * (lane & 3);
      const int left = r < rows ? N - n0 - q : 0;
      cp_async16(slot + exp_row_at(r) + q,
                 left > 0 ? we + (size_t)(row0 + r) * N + n0 + q : we,
                 max(0, min(16, left)));
    } else {
      const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * t + h;
        const int left = r < rows ? N - n0 - 8 * g8 : 0;
        uint8_t* d = slot + exp_row_at(r) + 8 * g8;
        const uint8_t* src = we + (size_t)(row0 + r) * N + n0 + 8 * g8;
        if (vec >= 8) {
          cp_async8(d, left > 0 ? src : we, left > 0 ? 8 : 0);
        } else {
          uint32_t b[2];
          load_bytes<8>(we, (size_t)(row0 + r) * N + n0 + 8 * g8, left,
                        false, b);
          *reinterpret_cast<uint2*>(d) = make_uint2(b[0], b[1]);
        }
      }
    }
    if (++ps == kfull) {
      ps = 0;
      ++pg;
    }
  }
  cp_async_commit();
  ++pj;
}

template <int MODE>
__global__ void __launch_bounds__(kExpWarps * 32, kExpCtas)
cim_mvm_packed_experts_kernel(const float* __restrict__ x,
                              const uint8_t* __restrict__ w,
                              float* __restrict__ out, int M, int N, int K,
                              int KW, int n_rows, int G, int gs, int blocks,
                              long n_steps, int vec_x, int vec_w,
                              float inv_lsb, float lsb, float code_max,
                              Stochastic st) {
  extern __shared__ uint8_t smem_b[];
  const int nq = n_rows >> 2;                       // chunks per group
  const int half = n_rows >> 1;                     // byte rows per group
  const int kfull = (nq + 3) >> 2;                  // k-steps of a group
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wc = kExpWarps / gs;
  const int g8 = lane >> 2, t = lane & 3;
  const int ct = warp % wc;                         // the warp's column tile
  const int sl = warp / wc;                         // ... and group slice
  // the warps' rings, then the split groups' codes
  uint8_t* slots = smem_b + (size_t)warp * kExpRing * kExpStep;
  uint16_t* cs = reinterpret_cast<uint16_t*>(
      smem_b + (size_t)kExpWarps * kExpRing * kExpStep);
  const int gb = sl * G / gs, ge = (sl + 1) * G / gs;
  const int mt = (M + kExpRows - 1) / kExpRows;
  const int nt = (N + kExpCols - 1) / kExpCols;
  uint32_t h0 = 0u;
  if constexpr (MODE != kIdeal)
    h0 = mix32(((uint32_t)__ldg(st.seed) ^ st.salt) ^ kGolden);

  const long s_end = (blockIdx.x + 1) * n_steps / gridDim.x;
  for (long step = blockIdx.x * n_steps / gridDim.x; step < s_end; ++step) {
    const long item = step / blocks;
    const int tile0 = (int)(step - item * blocks) * wc;
    const int e = (int)(item / mt);
    const int m0 = (int)(item - (long)e * mt) * kExpRows;
    const int n0 = (tile0 + ct) * kExpCols;
    const bool active = tile0 + ct < nt;
    const uint8_t* we = w + (size_t)e * KW * N;
    const bool row_ok = m0 + g8 < M;                // the lane's x row
    const float* xr = x + ((size_t)e * M + (row_ok ? m0 + g8 : 0)) * K;
    // the warp's k-steps: its groups' in order, all but the last full
    const int n_ks = active ? (ge - gb - 1) * kfull +
                                  exp_ksteps(ge - 1, nq, half, KW)
                            : 0;
    // the producer's next k-step (index, group, k-step in the group)
    int pj = 0, pg = gb, ps = 0;
#pragma unroll 1
    for (int i = 0; i < kExpRing - 1; ++i)
      exp_produce(slots, we, xr, row_ok, N, K, KW, nq, half, kfull, n0, lane,
                  n_ks, vec_w, vec_x, pj, pg, ps);

    // hash state after absorbing the salted seed, the row and the column
    uint32_t hrc[MODE == kIdeal ? 1 : kExpVals];
    if constexpr (MODE != kIdeal) {
#pragma unroll
      for (int v = 0; v < kExpVals; ++v)
        hrc[v] = mix32(mix32(h0 ^ (uint32_t)(m0 + exp_row(v, t))) ^
                       (uint32_t)(n0 + exp_col(v, g8)));
    }
    float o[kExpVals];
#pragma unroll
    for (int v = 0; v < kExpVals; ++v) o[v] = 0.f;

    int j = 0;                    // the consumer's k-step
    for (int grp = gb; active && grp < ge; ++grp) {
      const int ks = exp_ksteps(grp, nq, half, KW);
      int acc[4][4] = {};
      // three k-steps at a time at IDEAL (B6e's hash needs the registers)
#pragma unroll (MODE == kIdeal ? 3 : 1)
      for (int s = 0; s < ks; ++s, ++j) {
        cp_async_wait<kExpRing - 2>();              // k-step j has landed
        __syncwarp();             // ... for every lane; slot j - 1 is free
        const uint8_t* slot = slots + (j & (kExpRing - 1)) * kExpStep;
        const uint2 r0 = *reinterpret_cast<const uint2*>(
            slot + exp_row_at(2 * t) + 8 * g8);
        const uint2 r1 = *reinterpret_cast<const uint2*>(
            slot + exp_row_at(2 * t + 1) + 8 * g8);
        const int b = exp_pack(
            *reinterpret_cast<const float4*>(slot + kExpWBytes + 16 * lane));
        int cw[8];
        quad_columns(r0.x, r1.x, cw);
        quad_columns(r0.y, r1.y, cw + 4);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_s8(acc[q], cw[2 * q], cw[2 * q + 1], b);
        exp_produce(slots, we, xr, row_ok, N, K, KW, nq, half, kfull, n0,
                    lane, n_ks, vec_w, vec_x, pj, pg,
                    ps);          // into the slot k-step j - 1 has left
      }
      // TD-ADC transfer in registers
#pragma unroll
      for (int v = 0; v < kExpVals; ++v) {
        const float p = (float)acc[v >> 2][v & 3];  // exact: < 2^24
        float y = __fmul_rn(p, inv_lsb);
        if constexpr (MODE == kFull) {
          const float cf =
              fminf(fmaxf(__fmul_rn(p, st.frac_scale), 0.f), 1.f);
          y = __fmaf_rn(p, inv_lsb, inl_curve(cf, st));
        }
        if constexpr (MODE != kIdeal) {
          const uint32_t base =
              mix32(hrc[v] ^ ((uint32_t)grp * 0x01000193u));
          y = __fmaf_rn(st.sigma, normal12(base), y);
        }
        float code = rintf(y);
        code = fminf(fmaxf(code, 0.f), code_max);
        if (gs == 1)
          o[v] = __fmaf_rn(code, lsb, o[v]);
        else
          cs[((ct * G + grp) * kExpRows + exp_row(v, t)) * kExpCols +
             exp_col(v, g8)] = (uint16_t)code;      // exact: < 2^16
      }
    }
    cp_async_wait<0>();           // no copy outlives the step
    __syncwarp();

    if (gs == 1) {
      if (active) {
#pragma unroll
        for (int v = 0; v < kExpVals; ++v) {
          const int m = m0 + exp_row(v, t);
          const int n = n0 + exp_col(v, g8);
          if (m < M && n < N) out[((size_t)e * M + m) * N + n] = o[v];
        }
      }
    } else {
      // digital accumulation of the split groups, ascending group order;
      // eight codes fetched before their dependent multiply-adds
      __syncthreads();
      for (int idx = threadIdx.x; idx < wc * kExpRows * kExpCols;
           idx += blockDim.x) {
        const int tc = idx / (kExpRows * kExpCols);
        const int r = idx - tc * (kExpRows * kExpCols);
        const int mm = r / kExpCols;
        const int m = m0 + mm;
        const int n = (tile0 + tc) * kExpCols + r - mm * kExpCols;
        if (m >= M || n >= N) continue;
        const uint16_t* p = cs + (size_t)tc * G * kExpRows * kExpCols + r;
        float y = 0.f;
        for (int g0 = 0; g0 < G; g0 += 8) {
          float v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = g0 + q < G ? (float)p[(size_t)(g0 + q) * kExpRows *
                                         kExpCols]
                              : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (g0 + q < G) y = __fmaf_rn(v[q], lsb, y);
        }
        out[((size_t)e * M + m) * N + n] = y;
      }
    }
    if (gs > 1) __syncthreads();  // the next step parks codes here too
  }
}

// The card's SM count, read once.
cudaError_t sm_count(int* sms) {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = n;
  return cudaSuccess;
}

// The persistent launch of the expert-batched packed kernel; returns -1
// for groups of rows that are no multiple of four: the caller then takes
// the fallback body. It takes no launch knob (`used` reports {0, 0}).
template <int MODE>
int launch_packed_experts(const float* x, const uint8_t* w, float* out,
                          int E, int M, int N, int K, int KW, int n_rows,
                          int G, float inv_lsb, float lsb, float code_max,
                          const Stochastic& st, const Knobs& kn,
                          cudaStream_t stream) {
  if (n_rows % 4) return -1;
  auto kernel = cim_mvm_packed_experts_kernel<MODE>;
  const long mt = (M + kExpRows - 1) / kExpRows;
  const long nt = (N + kExpCols - 1) / kExpCols;
  int sms = 0;
  if (cudaError_t e = sm_count(&sms); e != cudaSuccess) return (int)e;
  // shared memory: the warps' rings, then the split groups' 16-bit codes
  auto smem_of = [&](int s) {
    return (size_t)kExpWarps * kExpRing * kExpStep +
           (s > 1 ? sizeof(uint16_t) * (size_t)(kExpWarps / s) * G *
                        kExpRows * kExpCols
                  : 0);
  };
  // The group slices: a step is a block of wc = kExpWarps / gs column
  // tiles, each over all G groups, and the busiest SM runs up to kExpCtas
  // CTAs of ceil(steps / CTAs) steps: the fewest slices that minimise that
  // SM's tile-groups, where the codes (16-bit) still leave kExpCtas CTAs
  // an SM; ties go to more resident CTAs where the card would be less than
  // half full. At qwen2-moe's decode the 64 experts take no split, the
  // expert-parallel slices (8 to 32 experts) do.
  int gs = 1;
  long best = 0, busy = 0;
  for (int s = 1; s <= kExpWarps && (s == 1 || s <= G); s *= 2) {
    if (s > 1 && (smem_of(s) > kSmemMax / kExpCtas || code_max > 65535.f))
      continue;
    const long steps = (long)E * mt * ((nt + kExpWarps / s - 1) /
                                       (kExpWarps / s));
    const long ctas = std::min(steps, (long)sms * kExpCtas);
    const long cost = (steps + ctas - 1) / ctas * ((ctas + sms - 1) / sms) *
                      (kExpWarps / s);
    if (s == 1 || cost < best ||
        (cost == best && ctas > busy && 2 * busy < (long)sms * kExpCtas)) {
      gs = s;
      best = cost;
      busy = ctas;
    }
  }
  const size_t smem = smem_of(gs);
  kn.report(0, 0);
  const int wc = kExpWarps / gs;
  const long blocks = (nt + wc - 1) / wc;
  const long n_steps = (long)E * mt * blocks;
  static size_t cap = 48 * 1024;   // raised once per instantiation and size
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  static size_t occ_smem = 0;      // CTAs an SM holds at that size
  static int occ = 0;
  if (smem != occ_smem || occ == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kExpWarps * 32, smem);
    if (e != cudaSuccess) return (int)e;
    occ_smem = smem;
  }
  const long grid = std::min(n_steps, (long)sms * std::max(occ, 1));
  const int vec_x = (K % 4 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (N % 16 == 0) && ((uintptr_t)w % 16 == 0) ? 16
                    : (N % 8 == 0) && ((uintptr_t)w % 8 == 0)   ? 8
                                                                : 0;
  kernel<<<(unsigned)grid, kExpWarps * 32, smem, stream>>>(
      x, w, out, M, N, K, KW, n_rows, G, gs, (int)blocks, n_steps, vec_x,
      vec_w, inv_lsb, lsb, code_max, st);
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

// ---- B2e / B5e: the expert-batched dense kernel ---------------------------
//
// x [E, M, K] f32 codes, w [E, K, N] f32 codes -> out [E, M, N], codes of
// at most 8 bits (the host's rule, from the MacroConfig's widths). A
// warp's unit of work is (expert, row tile of 8 NT rows, tile of 32 P
// columns) and, where that balances the SMs better, a slice of the
// groups; the CTAs (kDxWarps warps) walk a persistent grid of steps (item,
// block of column tiles), as B1e's do. NT = 1 (8 rows) for M <= 8, else NT
// = 5 (40 rows: qwen2-moe's training capacity in one tile), so each
// expert's weights are read once for all its rows up to 40. The column
// halves P are the launcher's choice (launch_dense_experts).
//
// k-step s of a group is 16 weight rows: quads c = 4 s .. 4 s + 3 of the
// group (rows 4c .. 4c + 3), lane (g8 = lane / 4, t = lane % 4) taking quad
// 4 s + t. Weights (32 P columns x 16 rows of f32) and activations (row m0
// + 8 i + g8's 4 codes of the lane's quad, for each n-tile i) arrive by
// cp.async copies in a shared-memory ring of kDxRing k-steps per warp.
// The lane reads its quad's 4 rows x 4 columns 4 g8 .. 4 g8 + 3 of each
// 32-column half p, and turns the 16 f32 codes into 4 words of u8 codes,
// one per column (its 4 rows, lowest first; exp_pack), once; they are the
// A rows g8 (columns 2s) and g8 + 8 (2s + 1) of MMA m-tile 2p + s. The
// activations become one u8x4 word per n-tile, the MMA's B (the same k
// order). The u8 m16n8k16 MMA sums each group exactly in s32; the lane's
// 8 NT P group sums are converted in registers and code * lsb is added to
// its outputs as one __fmaf_rn per group, in ascending group order. Split
// groups (gs > 1) park their codes in shared memory and the CTA sums them
// after a barrier, as in B1e.
constexpr int kDxWarps = 4;           // warps per CTA
constexpr int kDxRing = 4;            // k-steps in the ring of a warp

// a k-step's bytes in the ring: 16 rows of 32 P f32 weights, then 32
// lanes' 16-byte activation quads for each of the NT n-tiles
__host__ __device__ constexpr int dx_step(int nt, int p) {
  return 16 * 32 * p * 4 + nt * 32 * 16;
}

// k-steps of normal12x4's draw loop unrolled (of 12) at NT = 1 and 5: with
// all 12 unrolled, the ADC of a lane's 80 outputs ran to ~10,000
// instructions a group
__host__ __device__ constexpr int dx_hash_unroll(int nt) {
  return nt == 1 ? 3 : 2;
}

// normal12 of four conversions at once (the same draws, the same order of
// additions), the four chains interleaved and the draws' loop unrolled U
// times
template <int U>
__device__ __forceinline__ void normal12x4(const uint32_t (&base)[4],
                                           float (&n)[4]) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll (U)
  for (uint32_t j = 1; j <= 12; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc[u] = __fadd_rn(acc[u], __uint2float_rn(mix32(base[u] + j * kGolden)));
#pragma unroll
  for (int u = 0; u < 4; ++u)
    n[u] = __fsub_rn(__fmul_rn(acc[u], 0x1p-32f), 6.f);
}

// c (16 x 8, s32) += a (16 x 16, u8, rows g8 and g8 + 8) * b (16 x 8, u8)
__device__ __forceinline__ void mma_u8(int (&c)[4], int a0, int a1, int b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Byte offset of 16-byte chunk c (columns 4c .. 4c + 3) of weight row r
// in a ring slot of 8 P chunks a row: the chunk index is XORed with 2 (r /
// 4), so the 8 lanes of a quarter warp (two chunks g8, four quads t) hit 8
// distinct bank groups with their 16-byte reads.
template <int P>
__device__ __forceinline__ int dx_chunk(int r, int c) {
  return (r * 8 * P + (c ^ ((r >> 2) << 1))) * 16;
}

// k-steps of group grp: its quads that start below K, four a k-step
__device__ __forceinline__ int dx_ksteps(int grp, int nq, int n_rows,
                                         int K) {
  return (min(nq, (K - grp * n_rows + 3) >> 2) + 3) >> 2;
}

// The lane's output v = (m-tile T, n-tile i, accumulator r), v = (T NT +
// i) 4 + r: its column in the warp tile and its row in the row tile.
__device__ __forceinline__ int dx_col(int T, int r, int g8) {
  return 32 * (T >> 1) + 4 * g8 + 2 * (T & 1) + (r >> 1);
}
__device__ __forceinline__ int dx_row(int i, int r, int t) {
  return 8 * i + 2 * t + (r & 1);
}

// The producer side of a warp's ring: k-step pj (k-step ps of group pg)
// into slot pj % kDxRing, then one commit group (an empty one past the
// last k-step). Zeros past M, K and N, and for quads past the group's
// n_rows / 4; 4-byte copies where rows are not 16-byte aligned.
template <int NT, int P>
__device__ __forceinline__ void dx_produce(uint8_t* slots,
                                           const float* __restrict__ we,
                                           const float* __restrict__ xe,
                                           int m0, int M, int N, int K,
                                           int nq, int n_rows, int kfull,
                                           int n0, int lane, int n_ks,
                                           int vec_w, int vec_x, int& pj,
                                           int& pg, int& ps) {
  static_assert((kDxRing & (kDxRing - 1)) == 0, "a power of two");
  constexpr int kWBytes = 16 * 32 * P * 4;
  uint8_t* slot = slots + (pj & (kDxRing - 1)) * dx_step(NT, P);
  if (pj < n_ks) {
    const int kg = pg * n_rows;                     // the group's first k
    {
      const int c = 4 * ps + (lane & 3);            // the lane's quad
      const int k = kg + 4 * c;
      const int left = c < nq ? K - k : 0;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int m = m0 + 8 * i + (lane >> 2);
        const int l = m < M ? left : 0;
        const float* src = xe + (l > 0 ? (size_t)m * K + k : 0);
        float* d = reinterpret_cast<float*>(slot + kWBytes +
                                            16 * (32 * i + lane));
        if (vec_x) {
          cp_async16(d, src, l > 0 ? 16 : 0);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async4(d + u, l > u ? src + u : xe, l > u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * P; ++i) {
      const int id = 32 * i + lane;
      const int r = id / (8 * P), c = id % (8 * P);   // row, chunk
      const int row = kg + 16 * ps + r;
      const bool ok = 4 * ps + (r >> 2) < nq && row < K;
      const int n = n0 + 4 * c;
      uint8_t* d = slot + dx_chunk<P>(r, c);
      const float* src = we + (size_t)row * N + n;
      if (vec_w) {
        const bool in = ok && n < N;
        cp_async16(d, in ? src : we, in ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = ok && n + u < N;
          cp_async4(reinterpret_cast<float*>(d) + u, in ? src + u : we, in);
        }
      }
    }
    if (++ps == kfull) {
      ps = 0;
      ++pg;
    }
  }
  cp_async_commit();
  ++pj;
}

// The consumer side: the k-step in `slot` once every lane's copies have
// landed (slot j - 1 is then free), its f32 codes to u8 words, and the
// MMAs of its NT n-tiles x 2 P m-tiles into acc.
template <int NT, int P>
__device__ __forceinline__ void dx_consume(int (&acc)[2 * P][NT][4],
                                           const uint8_t* slot, int lane) {
  constexpr int kWBytes = 16 * 32 * P * 4;
  const int g8 = lane >> 2, t = lane & 3;
  cp_async_wait<kDxRing - 2>();                     // this k-step has landed
  __syncwarp();                   // ... for every lane; slot j - 1 is free
  int b[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    b[i] = exp_pack(*reinterpret_cast<const float4*>(
        slot + kWBytes + 16 * (32 * i + lane)));
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      q[u] = *reinterpret_cast<const float4*>(
          slot + dx_chunk<P>(4 * t + u, 8 * p + g8));
    const int a0 = exp_pack(make_float4(q[0].x, q[1].x, q[2].x, q[3].x));
    const int a1 = exp_pack(make_float4(q[0].y, q[1].y, q[2].y, q[3].y));
    const int a2 = exp_pack(make_float4(q[0].z, q[1].z, q[2].z, q[3].z));
    const int a3 = exp_pack(make_float4(q[0].w, q[1].w, q[2].w, q[3].w));
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      mma_u8(acc[2 * p][i], a0, a1, b[i]);
      mma_u8(acc[2 * p + 1][i], a2, a3, b[i]);
    }
  }
}

// k-step j of a warp's ring: its MMAs, then the copy of k-step j +
// kDxRing - 1 into the slot k-step j - 1 has left.
template <int NT, int P>
__device__ __forceinline__ void dx_kstep(int (&acc)[2 * P][NT][4],
                                         uint8_t* slots,
                                         const float* __restrict__ we,
                                         const float* __restrict__ xe,
                                         int m0, int M, int N, int K, int nq,
                                         int n_rows, int kfull, int n0,
                                         int lane, int n_ks, int vec_w,
                                         int vec_x, int& j, int& pj, int& pg,
                                         int& ps) {
  dx_consume<NT, P>(acc, slots + (j & (kDxRing - 1)) * dx_step(NT, P), lane);
  dx_produce<NT, P>(slots, we, xe, m0, M, N, K, nq, n_rows, kfull, n0, lane,
                    n_ks, vec_w, vec_x, pj, pg, ps);
  ++j;
}

template <int NT, int P, int MODE>
__global__ void __launch_bounds__(kDxWarps * 32, NT == 5 ? 2 : 3)
cim_mvm_dense_experts_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int M, int N, int K,
                             int n_rows, int G, int gs, int blocks,
                             long n_steps, int vec_x, int vec_w,
                             float inv_lsb, float lsb, float code_max,
                             Stochastic st) {
  constexpr int kRows = 8 * NT;                     // rows of a row tile
  constexpr int kCols = 32 * P;                     // columns of a warp tile
  constexpr int kStep = dx_step(NT, P);
  constexpr int kWBytes = 16 * kCols * 4;
  constexpr int kTiles = 2 * P;                     // MMA m-tiles
  constexpr int kVals = 4 * kTiles * NT;            // the lane's outputs
  // hash state after the row and column absorptions, per output
  constexpr int kHash = MODE == kIdeal ? 1 : kVals;
  extern __shared__ uint8_t smem_b[];
  const int nq = n_rows >> 2;                       // quads per group
  const int kfull = (nq + 3) >> 2;                  // k-steps of a group
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wc = kDxWarps / gs;
  const int g8 = lane >> 2, t = lane & 3;
  const int ct = warp % wc;                         // the warp's column tile
  const int sl = warp / wc;                         // ... and group slice
  uint8_t* slots = smem_b + (size_t)warp * kDxRing * kStep;
  uint16_t* cs = reinterpret_cast<uint16_t*>(
      smem_b + (size_t)kDxWarps * kDxRing * kStep);
  const int gb = sl * G / gs, ge = (sl + 1) * G / gs;
  const int mt = (M + kRows - 1) / kRows;
  const int nt = (N + kCols - 1) / kCols;
  uint32_t h0 = 0u;
  if constexpr (MODE != kIdeal)
    h0 = mix32(((uint32_t)__ldg(st.seed) ^ st.salt) ^ kGolden);

  const long s_end = (blockIdx.x + 1) * n_steps / gridDim.x;
  for (long step = blockIdx.x * n_steps / gridDim.x; step < s_end; ++step) {
    const long item = step / blocks;
    const int tile0 = (int)(step - item * blocks) * wc;
    const int e = (int)(item / mt);
    const int m0 = (int)(item - (long)e * mt) * kRows;
    const int n0 = (tile0 + ct) * kCols;
    const bool active = tile0 + ct < nt;
    const float* we = w + (size_t)e * K * N;
    const float* xe = x + (size_t)e * M * K;
    // the warp's k-steps: its groups' in order, all but the last full
    const int n_ks = active ? (ge - gb - 1) * kfull +
                                  dx_ksteps(ge - 1, nq, n_rows, K)
                            : 0;
    int pj = 0, pg = gb, ps = 0;
#pragma unroll 1
    for (int i = 0; i < kDxRing - 1; ++i)
      dx_produce<NT, P>(slots, we, xe, m0, M, N, K, nq, n_rows, kfull, n0,
                        lane, n_ks, vec_w, vec_x, pj, pg, ps);

    // hash state after absorbing the salted seed, the row and the column
    uint32_t hs[kHash];
    if constexpr (MODE != kIdeal) {
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        const int T = v / (4 * NT), i = (v >> 2) % NT, r = v & 3;
        hs[v] = mix32(mix32(h0 ^ (uint32_t)(m0 + dx_row(i, r, t))) ^
                      (uint32_t)(n0 + dx_col(T, r, g8)));
      }
    }
    float o[kVals];
#pragma unroll
    for (int v = 0; v < kVals; ++v) o[v] = 0.f;

    int j = 0;                    // the consumer's k-step
    for (int grp = gb; active && grp < ge; ++grp) {
      const int ks = dx_ksteps(grp, nq, n_rows, K);
      int acc[kTiles][NT][4];
#pragma unroll
      for (int T = 0; T < kTiles; ++T)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[T][i][r] = 0;
#pragma unroll 1
      for (int s = 0; s < ks; ++s)
        dx_kstep<NT, P>(acc, slots, we, xe, m0, M, N, K, nq, n_rows, kfull,
                        n0, lane, n_ks, vec_w, vec_x, j, pj, pg, ps);
      // TD-ADC transfer in registers, an MMA tile's 4 sums at a time
#pragma unroll
      for (int T = 0; T < kTiles; ++T)
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          float y[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = (float)acc[T][i][r];    // exact: < 2^24
            y[r] = __fmul_rn(p, inv_lsb);
            if constexpr (MODE == kFull) {
              const float cf =
                  fminf(fmaxf(__fmul_rn(p, st.frac_scale), 0.f), 1.f);
              y[r] = __fmaf_rn(p, inv_lsb, inl_curve(cf, st));
            }
          }
          if constexpr (MODE != kIdeal) {
            uint32_t base[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              base[r] = mix32(hs[(T * NT + i) * 4 + r] ^
                              ((uint32_t)grp * 0x01000193u));
            float nz[4];
            normal12x4<dx_hash_unroll(NT)>(base, nz);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              y[r] = __fmaf_rn(st.sigma, nz[r], y[r]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float code = rintf(y[r]);
            code = fminf(fmaxf(code, 0.f), code_max);
            const int v = (T * NT + i) * 4 + r;
            if (gs == 1)
              o[v] = __fmaf_rn(code, lsb, o[v]);
            else
              cs[((ct * G + grp) * kRows + dx_row(i, r, t)) * kCols +
                 dx_col(T, r, g8)] = (uint16_t)code;    // exact: < 2^16
          }
        }
    }
    cp_async_wait<0>();           // no copy outlives the step
    __syncwarp();

    if (gs == 1) {
      if (active) {
        // four columns 4 g8 .. 4 g8 + 3 of each half p at a time
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int rb = 0; rb < 2; ++rb) {
              const int m = m0 + dx_row(i, rb, t);
              const int n = n0 + 32 * p + 4 * g8;
              if (m >= M || n >= N) continue;
              const int v0 = ((2 * p) * NT + i) * 4, v1 = v0 + 4 * NT;
              const float c4[4] = {o[v0 + rb], o[v0 + 2 + rb], o[v1 + rb],
                                   o[v1 + 2 + rb]};
              float* dst = out + ((size_t)e * M + m) * N + n;
              if ((N & 3) == 0) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(c4[0], c4[1], c4[2], c4[3]);
              } else {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  if (n + u < N) dst[u] = c4[u];
              }
            }
      }
    } else {
      // digital accumulation of the split groups, ascending group order;
      // eight codes fetched before their dependent multiply-adds
      __syncthreads();
      for (int idx = threadIdx.x; idx < wc * kRows * kCols;
           idx += blockDim.x) {
        const int tc = idx / (kRows * kCols);
        const int r = idx - tc * (kRows * kCols);
        const int mm = r / kCols;
        const int m = m0 + mm;
        const int n = (tile0 + tc) * kCols + r - mm * kCols;
        if (m >= M || n >= N) continue;
        const uint16_t* p = cs + (size_t)tc * G * kRows * kCols + r;
        float y = 0.f;
        for (int g0 = 0; g0 < G; g0 += 8) {
          float v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = g0 + q < G ? (float)p[(size_t)(g0 + q) * kRows * kCols]
                              : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (g0 + q < G) y = __fmaf_rn(v[q], lsb, y);
        }
        out[((size_t)e * M + m) * N + n] = y;
      }
      __syncthreads();            // the next step parks codes here too
    }
  }
}

// The persistent launch of the expert-batched dense kernel at NT n-tiles
// and P column halves.
template <int NT, int P, int MODE>
int launch_dense_experts_nt(const float* x, const float* w, float* out,
                            int E, int M, int N, int K, int n_rows, int G,
                            float inv_lsb, float lsb, float code_max,
                            const Stochastic& st, cudaStream_t stream) {
  constexpr int kRows = 8 * NT, kCols = 32 * P;
  auto kernel = cim_mvm_dense_experts_kernel<NT, P, MODE>;
  const long mt = (M + kRows - 1) / kRows;
  const long nt = (N + kCols - 1) / kCols;
  static bool raised = false;      // the shared-memory cap, raised once
  int sms = 0;
  if (cudaError_t e = sm_count(&sms); e != cudaSuccess) return (int)e;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  // shared memory: the warps' rings, then the split groups' 16-bit codes
  auto smem_of = [&](int s) {
    return (size_t)kDxWarps * kDxRing * dx_step(NT, P) +
           (s > 1 ? sizeof(uint16_t) * (size_t)(kDxWarps / s) * G * kRows *
                        kCols
                  : 0);
  };
  // CTAs an SM holds at a shared-memory size (the last few sizes kept)
  static size_t occ_smem[4] = {};
  static int occ_n[4] = {};
  auto occupancy = [&](size_t smem, int* occ) {
    for (int i = 0; i < 4; ++i)
      if (occ_smem[i] == smem && occ_n[i] > 0) {
        *occ = occ_n[i];
        return cudaSuccess;
      }
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kernel, kDxWarps * 32, smem);
    if (e == cudaSuccess) {
      for (int i = 3; i > 0; --i) {
        occ_smem[i] = occ_smem[i - 1];
        occ_n[i] = occ_n[i - 1];
      }
      occ_smem[0] = smem;
      occ_n[0] = *occ;
    }
    return e;
  };
  // The group slices, as B1e chooses them: the fewest that minimise the
  // busiest SM's tile-groups, ties to more resident CTAs; slices only
  // where one per column tile leaves the card less than full (deepseek-v3
  // and qwen2-moe's 64 experts take none, the expert-parallel slices do).
  int gs = 1, occ1 = 0;
  long best = 0, busy = 0;
  for (int s = 1; s <= kDxWarps && (s == 1 || s <= G); s *= 2) {
    if (s > 1 && (smem_of(s) > kSmemMax || code_max > 65535.f)) continue;
    int occ = 0;
    cudaError_t e = occupancy(smem_of(s), &occ);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) continue;
    const long steps = (long)E * mt * ((nt + kDxWarps / s - 1) /
                                       (kDxWarps / s));
    if (s == 1) occ1 = occ;
    else if (busy >= (long)sms * occ1) break;
    const long ctas = std::min(steps, (long)sms * occ);
    const long cost = (steps + ctas - 1) / ctas * ((ctas + sms - 1) / sms) *
                      (kDxWarps / s);
    if (s == 1 || cost < best || (cost == best && ctas > busy)) {
      gs = s;
      best = cost;
      busy = ctas;
    }
  }
  if (occ1 < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_of(gs);
  const int wc = kDxWarps / gs;
  const long blocks = (nt + wc - 1) / wc;
  const long n_steps = (long)E * mt * blocks;
  int occ = 0;
  cudaError_t e = occupancy(smem, &occ);
  if (e != cudaSuccess) return (int)e;
  const long grid = std::min(n_steps, (long)sms * std::max(occ, 1));
  const int vec_x = (K % 4 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (N % 4 == 0) && ((uintptr_t)w % 16 == 0);
  kernel<<<(unsigned)grid, kDxWarps * 32, smem, stream>>>(
      x, w, out, M, N, K, n_rows, G, gs, (int)blocks, n_steps, vec_x, vec_w,
      inv_lsb, lsb, code_max, st);
  return (int)cudaGetLastError();
}

// B2e / B5e's MMA body; returns -1 where it cannot take the launch (the
// caller then takes the dense kernel's): groups of rows that are no
// multiple of four (a quad would straddle two groups), or codes whose
// width is not stated (code_bits 0) or exceeds the u8 operand, or whose
// group sums could reach 2^24 (n_rows (2^b - 1)^2). The host chooses from
// the shape and the widths, never from the data. It takes no launch knob
// (`used` reports {0, 0}).
template <int MODE>
int launch_dense_experts(const float* x, const float* w, float* out, int E,
                         int M, int N, int K, int n_rows, int G,
                         float inv_lsb, float lsb, float code_max,
                         int code_bits, const Stochastic& st,
                         const Knobs& kn, cudaStream_t stream) {
  if (n_rows % 4 || code_bits < 1 || code_bits > 8) return -1;
  const long cmax = (1L << code_bits) - 1;
  if ((long)n_rows * cmax * cmax >= (1L << 24)) return -1;
  kn.report(0, 0);
  // 40-row tiles: 64 columns a warp, but 32 for the stochastic converter,
  // where 80 outputs a lane left no registers for the counter hash
  // (spills at 255; 40 outputs a lane take 204 registers with their hash
  // state cached per output)
  if (M > 8) {
    if constexpr (MODE == kIdeal)
      return launch_dense_experts_nt<5, 2, MODE>(
          x, w, out, E, M, N, K, n_rows, G, inv_lsb, lsb, code_max, st,
          stream);
    else
      return launch_dense_experts_nt<5, 1, MODE>(
          x, w, out, E, M, N, K, n_rows, G, inv_lsb, lsb, code_max, st,
          stream);
  }
  // 8-row tiles: 128 columns a warp (512-byte row pieces; one CTA an SM
  // by its ring) where the launch gives every SM at least 4 steps of 4
  // such tiles (deepseek-v3's 256 experts), 64 columns otherwise (the
  // expert-parallel slices, which 128-column tiles leave short of steps)
  if constexpr (MODE == kIdeal) {
    int sms = 0;
    if (cudaError_t e = sm_count(&sms); e != cudaSuccess) return (int)e;
    if ((long)E * (((N + 127) / 128 + 3) / 4) >= 4L * sms)
      return launch_dense_experts_nt<1, 4, MODE>(
          x, w, out, E, M, N, K, n_rows, G, inv_lsb, lsb, code_max, st,
          stream);
  }
  return launch_dense_experts_nt<1, 2, MODE>(
      x, w, out, E, M, N, K, n_rows, G, inv_lsb, lsb, code_max, st, stream);
}

template <bool PACKED, int MODE, bool EXPERTS>
int dispatch_rows(const float* x, const void* w, float* out, int E, int M,
                  int N, int K, int KW, int n_rows, int G, float inv_lsb,
                  float lsb, float code_max, const Stochastic& st,
                  const Knobs& kn, cudaStream_t stream, int code_bits) {
  if constexpr (!PACKED) {
    const float* wf = static_cast<const float*>(w);
    if constexpr (EXPERTS) {
      const int rc = launch_dense_experts<MODE>(
          x, wf, out, E, M, N, K, n_rows, G, inv_lsb, lsb, code_max,
          code_bits, st, kn, stream);
      if (rc != -1) return rc;
    }
    return M <= 4 ? launch_dense<4, MODE, EXPERTS>(x, wf, out, E, M, N, K,
                                                   n_rows, G, inv_lsb, lsb,
                                                   code_max, st, kn, stream)
                  : launch_dense<8, MODE, EXPERTS>(x, wf, out, E, M, N, K,
                                                   n_rows, G, inv_lsb, lsb,
                                                   code_max, st, kn, stream);
  } else {
    const uint8_t* wp = static_cast<const uint8_t*>(w);
    int rc;
    if constexpr (EXPERTS)
      rc = launch_packed_experts<MODE>(x, wp, out, E, M, N, K, KW, n_rows,
                                       G, inv_lsb, lsb, code_max, st, kn,
                                       stream);
    else
      rc = M <= 4 ? launch_packed<4, 16, MODE>(x, wp, out, M, N, K, KW,
                                               n_rows, G, inv_lsb, lsb,
                                               code_max, st, kn, stream)
                  : launch_packed<8, 8, MODE>(x, wp, out, M, N, K, KW,
                                              n_rows, G, inv_lsb, lsb,
                                              code_max, st, kn, stream);
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
             cudaStream_t stream, int code_bits = 0) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  switch (mode) {
    case kIdeal:
      return dispatch_rows<PACKED, kIdeal, EXPERTS>(
          x, w, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st,
          kn, stream, code_bits);
    case kNoisy:
      return dispatch_rows<PACKED, kNoisy, EXPERTS>(
          x, w, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st,
          kn, stream, code_bits);
    case kFull:
      return dispatch_rows<PACKED, kFull, EXPERTS>(
          x, w, out, E, M, N, K, KW, n_rows, G, inv_lsb, lsb, code_max, st,
          kn, stream, code_bits);
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
// own template instances). code_bits: the wider of the activation and
// weight code widths (the MacroConfig's act_bits / weight_bits), 0 when
// the caller does not state it; the MMA body takes codes of at most 8
// bits, every other launch the dense kernel's body.
int cim_mvm_dense_experts_launch(const float* x, const float* w, float* out,
                                 int E, int M, int N, int K, int n_rows,
                                 float inv_lsb, float lsb, float code_max,
                                 int code_bits, int cluster, int wcols,
                                 int* used, cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  const Stochastic none{};
  return dispatch<false, true>(x, w, out, E, M, N, K, K, n_rows,
                               groups(K, n_rows), inv_lsb, lsb, code_max,
                               kIdeal, none, kn, stream, code_bits);
}

// B5, expert-batched. The counter hash takes the row within the expert and
// no expert index, so every expert draws the noise B5 draws on its own.
int cim_mvm_noisy_dense_experts_launch(const float* x, const float* w,
                                       float* out, int E, int M, int N,
                                       int K, int n_rows, float inv_lsb,
                                       float lsb, float code_max, int mode,
                                       const int* seed, unsigned salt,
                                       float sigma, const float* inl,
                                       int code_bits, int cluster, int wcols,
                                       int* used, cudaStream_t stream) {
  const Knobs kn = make_knobs(cluster, wcols, used);
  if (mode != kNoisy && mode != kFull) return (int)cudaErrorInvalidValue;
  const Stochastic st = make_stochastic(seed, salt, sigma, inl);
  return dispatch<false, true>(x, w, out, E, M, N, K, K, n_rows,
                               groups(K, n_rows), inv_lsb, lsb, code_max,
                               mode, st, kn, stream, code_bits);
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
