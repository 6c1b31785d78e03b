// Paged attention for Hopper (sm_90a): kernels B3 and B4 of the port.
//
// B3 replaces kernels/paged_attention.py:_paged_attn_call of the JAX
// package (_paged_attn_kernel): flash attention of the queries of one
// serving step over K/V block pools, read through per-slot block tables.
//   q [B, C, H, dh] f32; pools [NB, bs, KH, dh] bf16 or f32;
//   tables [B, MB] i32; lens, kv_len [B] i32; out [B, C, H, dh] f32.
// GQA folds the G = H / KH query heads of a KV head and the C chunk
// positions into C*G rows: row r is chunk offset r / G, head h*G + r % G.
// Masks: pos_s <= lens + r / G (causal in the chunk) and pos_s < kv_len.
// Masked scores are -1e30 and their weights are forced to exactly 0; V
// rows at or past kv_len are zeroed by selection before the PV sum (the
// trash block may hold NaN, and 0 * NaN is NaN); the output is
// acc / max(l, 1e-30), so idle lanes (kv_len 0) emit 0. Math is f32 with
// scale = 1/sqrt(dh); the pools are upcast as they are loaded.
//
// What bounds B3 on the H100: the bytes of K/V it reads (each slot's
// kv_len rows of one KV head per block), and at decode sizes the launch
// itself: a step attends over at most a few hundred tokens.
// What the design does about that: one thread block per (slot, KV head,
// tile of 4 rows); the block loads its own table entries and walks only
// the slot's blocks below kv_len, staging each [bs, dh] K and V block in
// shared memory once for all its rows (one warp per row). Online-softmax
// state (m, l and the dh-wide accumulator, dh/32 values per lane) lives
// in registers for the whole pass. No score tensor is ever written out.
// Every float operation is an explicit _rn intrinsic (nothing is
// contracted into an FMA) and every sum has a fixed order: lane-strided
// partial dot products, then the xor butterfly over the warp; the
// per-token PV sum in token order. The plain PyTorch version follows the
// same order, so on the card the two agree bit for bit.
//
// B4 replaces kernels/paged_attention.py:_fused_write_call
// (_fused_write_kernel): the decode step's K/V row of each slot is copied
// in place into pool row flat_idx (block flat/bs, offset flat%bs); a lane
// with flat_idx 0 writes nothing. Bound by launch latency: it moves
// 2 * B * KH * dh elements. One block per slot; 16-bit or 32-bit words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;                  // query rows (warps) per block
constexpr int kThreads = kRows * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int DPL>   // DPL = dh / 32 values per lane
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, const int* __restrict__ kvl,
                  float* __restrict__ out, int C, int H, int KH, int G,
                  int bs, int MB, float scale) {
  constexpr int dh = DPL * 32;
  extern __shared__ float smem[];
  float* ks = smem;             // [bs][dh]
  float* vs = smem + bs * dh;   // [bs][dh]
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.z * kRows + warp;
  const bool live = row < C * G;
  const int c_off = live ? row / G : 0;
  const int head = h * G + (live ? row % G : 0);
  const int kv = kvl[b];
  const int pos_q = lens[b] + c_off;

  float qr[DPL];
  float acc[DPL];
  const size_t qbase = (((size_t)b * C + c_off) * H + head) * dh;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qr[i] = live ? q[qbase + lane + 32 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f;
  float l = 0.f;

  const int nblk = (kv + bs - 1) / bs;   // blocks holding attendable rows
  for (int j = 0; j < nblk; ++j) {
    const int blk = tables[(size_t)b * MB + j];
    __syncthreads();
    for (int idx = threadIdx.x; idx < bs * dh; idx += kThreads) {
      const int t = idx / dh;
      const int d = idx - t * dh;
      const size_t src = (((size_t)blk * bs + t) * KH + h) * dh + d;
      ks[idx] = to_f32(kpool[src]);
      const float vv = to_f32(vpool[src]);
      vs[idx] = (j * bs + t < kv) ? vv : 0.f;   // select, never multiply
    }
    __syncthreads();
    if (!live) continue;

    // scores of this block: lane t keeps s_t (bs <= 32)
    float my_s = -1e30f;
    bool my_ok = false;
    for (int t = 0; t < bs; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        part = __fadd_rn(part, __fmul_rn(qr[i], ks[t * dh + lane + 32 * i]));
      const float s = __fmul_rn(warp_sum(part), scale);
      const int pos_s = j * bs + t;
      const bool ok = (pos_s <= pos_q) && (pos_s < kv);
      if (lane == t) {
        my_ok = ok;
        my_s = ok ? s : -1e30f;
      }
    }
    const float m_new = fmaxf(m, warp_max(my_s));
    const float p = my_ok ? expf(__fsub_rn(my_s, m_new)) : 0.f;
    const float alpha = expf(__fsub_rn(m, m_new));
    l = __fadd_rn(__fmul_rn(l, alpha), warp_sum(p));
    float pv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
    for (int t = 0; t < bs; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        pv[i] = __fadd_rn(pv[i], __fmul_rn(pt, vs[t * dh + lane + 32 * i]));
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha), pv[i]);
    m = m_new;
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) out[qbase + lane + 32 * i] = __fdiv_rn(acc[i], den);
}

template <typename T, int DPL>
int launch_attn(const float* q, const void* k, const void* v,
                const int* tables, const int* lens, const int* kvl,
                float* out, int B, int C, int H, int KH, int bs, int MB,
                float scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = sizeof(float) * 2 * (size_t)bs * DPL * 32;
  static size_t cap = 48 * 1024;   // raised once, not per (captured) launch
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  dim3 grid(B, KH, (C * G + kRows - 1) / kRows);
  paged_attn_kernel<T, DPL><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), tables, lens,
      kvl, out, C, H, KH, G, bs, MB, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const float* q, const void* k, const void* v,
                const int* tables, const int* lens, const int* kvl,
                float* out, int B, int C, int H, int KH, int dh, int bs,
                int MB, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_attn<T, 1>(q, k, v, tables, lens, kvl, out, B, C, H, KH,
                               bs, MB, scale, stream);
    case 64:
      return launch_attn<T, 2>(q, k, v, tables, lens, kvl, out, B, C, H, KH,
                               bs, MB, scale, stream);
    case 128:
      return launch_attn<T, 4>(q, k, v, tables, lens, kvl, out, B, C, H, KH,
                               bs, MB, scale, stream);
    case 256:
      return launch_attn<T, 8>(q, k, v, tables, lens, kvl, out, B, C, H, KH,
                               bs, MB, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename W>
__global__ void fused_write_kernel(W* __restrict__ kpool,
                                   W* __restrict__ vpool,
                                   const W* __restrict__ nk,
                                   const W* __restrict__ nv,
                                   const int* __restrict__ flat,
                                   int row_elems) {
  const int b = blockIdx.x;
  const int f = flat[b];
  if (f == 0) return;   // invalid lane: no write (the trash block keeps its bits)
  const size_t dst = (size_t)f * row_elems;
  const size_t src = (size_t)b * row_elems;
  for (int i = threadIdx.x; i < row_elems; i += blockDim.x) {
    kpool[dst + i] = nk[src + i];
    vpool[dst + i] = nv[src + i];
  }
}

}  // namespace

extern "C" {

// B3. pool_bf16: 1 for bf16 pools, 0 for f32 pools.
int paged_attn_launch(int pool_bf16, const float* q, const void* k,
                      const void* v, const int* tables, const int* lens,
                      const int* kvl, float* out, int B, int C, int H,
                      int KH, int dh, int bs, int MB, float scale,
                      cudaStream_t stream) {
  if (B <= 0 || C <= 0) return 0;
  if (bs < 1 || bs > 32 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  if (pool_bf16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, tables, lens, kvl, out, B, C,
                                      H, KH, dh, bs, MB, scale, stream);
  return dispatch_dh<float>(q, k, v, tables, lens, kvl, out, B, C, H, KH, dh,
                            bs, MB, scale, stream);
}

// B4. elem_bytes: 2 (bf16) or 4 (f32); row_elems = KH * dh; flat [B] i32.
int fused_write_launch(int elem_bytes, void* k, void* v, const void* nk,
                       const void* nv, const int* flat, int B, int row_elems,
                       cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = row_elems < 256 ? 128 : 256;
  if (elem_bytes == 2)
    fused_write_kernel<uint16_t><<<B, threads, 0, stream>>>(
        static_cast<uint16_t*>(k), static_cast<uint16_t*>(v),
        static_cast<const uint16_t*>(nk), static_cast<const uint16_t*>(nv),
        flat, row_elems);
  else if (elem_bytes == 4)
    fused_write_kernel<uint32_t><<<B, threads, 0, stream>>>(
        static_cast<uint32_t*>(k), static_cast<uint32_t*>(v),
        static_cast<const uint32_t*>(nk), static_cast<const uint32_t*>(nv),
        flat, row_elems);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
