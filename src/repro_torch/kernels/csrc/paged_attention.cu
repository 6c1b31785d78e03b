// Paged attention for Hopper (sm_90a): kernels B3 and B4 of the port, one
// kernel. B4 has no launch of its own: it rides in B3's decode launch.
//
// B3 replaces kernels/paged_attention.py:_paged_attn_call of the JAX
// package (_paged_attn_kernel): flash attention of the queries of one
// serving step over K/V block pools, read through per-slot block tables.
//   q [B, C, H, dh] bf16 or f32 (read as it is, upcast exactly to f32);
//   pools [NB, bs, KH, dh] bf16 or f32; tables [B, MB] i32; lens, kv_len
//   [B] i32; out [B, C, H, dh] f32, or bf16 rounded once to nearest even
//   (__float2bfloat16_rn, as torch's .to(torch.bfloat16) rounds).
// GQA folds the G = H / KH query heads of a KV head and the C chunk
// positions into C*G rows: row r is chunk offset r / G, head h*G + r % G.
// Masks: pos_s <= lens + r / G (causal in the chunk) and pos_s < kv_len.
// Masked scores are -1e30 and their weights are forced to exactly 0; V
// rows at or past kv_len are zeroed by selection before the PV sum (the
// trash block may hold NaN, and 0 * NaN is NaN); the output is
// acc / max(l, 1e-30), so idle lanes (kv_len 0) emit 0. Math is f32 with
// scale = 1/sqrt(dh); the pools are upcast as they are read. Any head dim
// 1 <= dh <= 256 and any block size bs >= 1 (the GEN instances below; the
// JAX kernel takes any dh and bs too). The pools may be a head slice of
// pools with KS >= KH heads a row, read in place (the STRIDED instances:
// a mesh rank's KV heads, where the JAX package's shard_map hands each
// shard its heads of the pools).
//
// What bounds B3 on the H100: the bytes of K/V it reads (each slot's
// kv_len rows of one KV head), a few hundred KB at decode, so in practice
// the latency of one launch and of one or two trips to device memory.
// What the design does about that (split-KV flash decoding):
//  * each (slot, KV head, tile of query rows) gets a thread-block cluster
//    of S = min(8, MB) CTAs (the wrapper's attn_splits; launched with
//    cudaLaunchKernelEx and a cluster-dimension attribute). S is fixed by
//    the table width MB, never by the device-side kv_len, so the launch
//    stays capturable in a CUDA graph. Rank r takes the contiguous table
//    columns [r*per, (r+1)*per), per = ceil(MB / S), and walks only those
//    below kv_len; a rank with nothing to read publishes the empty state
//    (m = -1e30, l = 0, acc = 0).
//    At decode (4 slots x 8 KV heads, MB = 16) that is 256 CTAs, not 32.
//  * all query rows of the tile share each staged K/V block: the block is
//    copied with 16-byte cp.async into shared memory, double-buffered, so
//    block j+1 arrives while block j is computed. Rows are padded by one
//    16-byte chunk, so the per-token 16-byte reads are conflict-free.
//  * scores are one token per lane: lane t forms the 32 lane-strided
//    partial dot products of q and k_t itself (dh/32 terms each, in order)
//    and sums them in the order of the warp's xor butterfly (16, 8, 4, 2,
//    1). That is the order the plain version writes down (`_butterfly`).
//    The online softmax (m, l, the dh-wide accumulator, dh/32 values per
//    lane) then runs per row as a single-pass kernel would; the PV sum in
//    token order.
//  * after cluster.sync(), the CTAs of the cluster combine the ranks'
//    (m, l, acc) read through distributed shared memory, each CTA a slice
//    of the tile's outputs, in rank order: m* = max_r m_r,
//    l* = sum_r l_r * exp(m_r - m*), acc* likewise, out = acc* /
//    max(l*, 1e-30). A second cluster.sync() keeps every CTA's shared
//    memory alive until its peers have read it.
// Every float operation is an explicit _rn intrinsic (nothing is
// contracted into an FMA) and every sum has a fixed order, which the plain
// PyTorch version follows, so on the card the two agree bit for bit.
//
// B4 replaces kernels/paged_attention.py:_fused_write_call
// (_fused_write_kernel): the decode step's K/V row of each slot is copied
// in place into pool row flat (block flat/bs, offset flat%bs); a lane with
// flat 0 writes nothing. It moves 2 * B * KH * dh elements (16 KB at
// decode), far below what a launch of its own costs (~1.9 us on the H100).
// So it is folded into B3's decode launch (C = 1), which already stages
// the block the row lands in:
//  * each CTA of a writing slot copies its KV head's slices of the new K
//    and V rows into shared memory with its first cp.async group;
//  * the CTA that stages the block holding pool row flat[b] overwrites
//    that row of the staged block from there once the block has landed,
//    so the attention sees the bytes that write-then-attend would read.
//    The staging loop itself stays as it was: choosing each chunk's
//    source there made every launch slower, B3's own ones too;
//  * after the first cluster.sync(), when every CTA of the cluster has
//    staged its blocks, rank 0 of row tile 0 stores the slices into pool
//    row flat[b]. Only that cluster reads slot b's head-h slices (a
//    second row tile, at G > 32, may stage either bytes of that row and
//    replaces them anyway), and under the copy-on-write contract (the JAX
//    package's fused_paged_write) no other slot maps the block, so no CTA
//    waits on another.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;      // warps per CTA
constexpr int kMaxSplit = 8;      // portable cluster size

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

// one step of the xor butterfly on 32 partials held by one lane: what
// lane u < O holds after the shuffle step of offset O
template <int O>
__device__ __forceinline__ void butterfly(float* part) {
#pragma unroll
  for (int u = 0; u < O; ++u) part[u] = __fadd_rn(part[u], part[u + O]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copy one unit of w in {16, 8, 4, 2} bytes from global to shared memory:
// cp.async for 16, 8 and 4 bytes, a plain load and store for 2 (cp.async
// moves no fewer than 4). Rows of dh * sizeof(T) bytes that are no
// multiple of 16 (bf16 dh 20: 40 bytes) lie only w-aligned in the pools.
__device__ __forceinline__ void copy_unit_async(void* dst, const void* src,
                                                int w) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (w == 16) {
    cp_async16(dst, src);
  } else if (w == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  } else if (w == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// The same unit, a plain load and store (shared -> shared or global).
__device__ __forceinline__ void copy_unit(void* dst, const void* src, int w) {
  if (w == 16)
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  else if (w == 8)
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  else if (w == 4)
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

// 16 bytes of pool elements -> f32
template <typename T>
__device__ __forceinline__ void chunk_f32(const unsigned char* p, float* f);
template <>
__device__ __forceinline__ void chunk_f32<float>(const unsigned char* p,
                                                 float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <>
__device__ __forceinline__ void chunk_f32<__nv_bfloat16>(
    const unsigned char* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);           // bf16 -> f32 is exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared-memory layout of one CTA (bytes), for T, the head dim padded to
// whole lanes dhp = 32 * DPL, sb tokens per staged K/V piece, tr query rows.
struct AttnSmem {
  int row_bytes, stage_bytes, kv_bytes, q_off, m_off, l_off, acc_off, w_off,
      total;
};
template <typename T>
__host__ __device__ inline AttnSmem attn_smem(int dhp, int sb, int tr) {
  AttnSmem s;
  s.row_bytes = dhp * (int)sizeof(T) + 16;  // one pad chunk per row
  s.stage_bytes = 2 * sb * s.row_bytes;     // K then V
  s.kv_bytes = 2 * s.stage_bytes;           // double buffer
  s.q_off = s.kv_bytes;
  s.m_off = s.q_off + tr * dhp * 4;
  s.l_off = s.m_off + tr * 4;
  s.acc_off = s.l_off + tr * 4;
  s.w_off = (s.acc_off + tr * dhp * 4 + 15) & ~15;  // B4's new K, V rows
  s.total = s.w_off + 2 * dhp * (int)sizeof(T);
  return s;
}

// The operands of one launch: B3 alone (flat null), or B3 with B4's decode
// write folded in (C = 1; nk, nv, flat set). Host side only: the kernel
// takes them as separate __restrict__ parameters.
struct AttnArgs {
  const void* q;        // [B, C, H, dh], bf16 if q_bf16 else f32
  void* k;              // pools [NB, bs, KH, dh] of T
  void* v;
  const void* nk;       // B4's new rows [B, 1, KH, dh] of T
  const void* nv;
  const int* flat;      // [B] pool row of each slot's new row, 0: none
  const int* tables;    // [B, MB]
  const int* lens;      // [B] chunk base
  const int* kvl;       // [B]
  void* out;            // [B, C, H, dh], bf16 if out_bf16 else f32
  int q_bf16, out_bf16, B, C, H, KH, G, dh, bs, MB, per;
  int KS;               // the pools' row stride in heads (KS >= KH)
  float scale;
};

// The online-softmax update of one query-row set over one staged piece of
// cnt <= 32 tokens at positions pos0.. (K rows at ks, V rows at vs, row_bytes
// apart): lane t scores token t.
template <typename T, int DPL, int RPW>
__device__ __forceinline__ void attend_piece(
    const unsigned char* ks, const unsigned char* vs, int row_bytes,
    const float* qs, int pos0, int cnt, int kv, int base, int row0,
    int rows, int G, int nwarps, int warp, int lane, float scale,
    float (&m)[RPW], float (&l)[RPW], float (&acc)[RPW][DPL]) {
  constexpr int DHP = DPL * 32;
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  const int tt = lane < cnt ? lane : cnt - 1;
  const int pos_s = pos0 + lane;
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int lr = warp + k * nwarps;
    if (row0 + lr >= rows) break;              // warp-uniform
    const int pos_q = base + (row0 + lr) / G;
    const float* qr = qs + lr * DHP;
    // score of token `lane`: 32 lane-strided partials, butterfly order
    float part[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) part[u] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
#pragma unroll
      for (int c = 0; c < 32 / EPC; ++c) {
        float kf[EPC];
        chunk_f32<T>(ks + tt * row_bytes + (i * 32 + c * EPC) *
                     (int)sizeof(T), kf);
#pragma unroll
        for (int u = 0; u < EPC; ++u)
          part[c * EPC + u] = __fadd_rn(
              part[c * EPC + u],
              __fmul_rn(qr[i * 32 + c * EPC + u], kf[u]));
      }
    }
    butterfly<16>(part);
    butterfly<8>(part);
    butterfly<4>(part);
    butterfly<2>(part);
    butterfly<1>(part);
    const float s = __fmul_rn(part[0], scale);
    const bool ok = lane < cnt && pos_s <= pos_q && pos_s < kv;
    const float my_s = ok ? s : -1e30f;
    const float m_new = fmaxf(m[k], warp_max(my_s));
    const float p = ok ? expf(__fsub_rn(my_s, m_new)) : 0.f;
    const float alpha = expf(__fsub_rn(m[k], m_new));
    l[k] = __fadd_rn(__fmul_rn(l[k], alpha), warp_sum(p));
    float pv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
    for (int t = 0; t < cnt; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      const bool vok = pos0 + t < kv;
      const T* vrow = reinterpret_cast<const T*>(vs + t * row_bytes);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float vv = vok ? to_f32(vrow[lane + 32 * i]) : 0.f;  // select
        pv[i] = __fadd_rn(pv[i], __fmul_rn(pt, vv));
      }
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      acc[k][i] = __fadd_rn(__fmul_rn(acc[k][i], alpha), pv[i]);
    m[k] = m_new;
  }
}

// One CTA: query rows [tile*TR, tile*TR + TR) of (slot b, KV head h),
// table columns of cluster rank `rank`. RPW rows per warp, TR = warps*RPW.
// WRITE: the decode launch with B4's write folded in. B3's own launches
// compile without that code: with it, nvcc allots the kernel about half
// the registers and B3 alone ran slower on the H100.
// GEN: the shapes past the fast case (dh a multiple of 32 in {32, 64, 128,
// 256} with bs <= 32), which compiles exactly as it did before GEN came:
//  * any head dim 1 <= dh <= 256: rows are padded to DHP = 32 * DPL in
//    shared memory (q with zeros, the staged K/V tails zeroed once), so a
//    lane past dh adds 0 * 0 to its partial and publishes nothing;
//  * rows of dh * sizeof(T) bytes that are no multiple of 16 are copied in
//    the widest unit of 8, 4 or 2 bytes that divides them;
//  * any block size: a block is staged and scored in pieces of at most 32
//    tokens (lane t scores token t of the piece), each piece its own
//    online-softmax update, so shared memory holds 2 x 2 x min(bs, 32)
//    rows whatever bs is. Pieces that start at or past kv_len are not read:
//    like columns past kv_len they would be exact no-ops.
// STRIDED: the pools are a head slice [NB, bs, KH, dh] of pools of KS
// heads a row (a mesh rank's KV heads, read in place; kpool / vpool
// point at the slice's first head). Without it KS is KH, and the index
// math is the unsliced pools' as before. Never with WRITE.
template <typename T, int DPL, int RPW, bool WRITE, bool GEN, bool STRIDED>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_attn_kernel(const void* __restrict__ q, T* __restrict__ kpool,
                  T* __restrict__ vpool, const T* __restrict__ nk,
                  const T* __restrict__ nv, const int* __restrict__ flat,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, const int* __restrict__ kvl,
                  void* __restrict__ out, int q_bf16, int out_bf16, int C,
                  int H, int KH, int G, int dh_arg, int bs, int MB, int per,
                  int tiles, float scale, int KS_arg) {
  static_assert(!(STRIDED && WRITE), "the strided pools take no write");
  constexpr int DHP = DPL * 32;
  constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte chunk
  constexpr int CPR = DHP / EPC;             // chunks per row
  const int dh = GEN ? dh_arg : DHP;
  const int sb = GEN ? min(bs, 32) : bs;     // tokens per staged piece
  const int KS = STRIDED ? KS_arg : KH;      // pool row stride in heads
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int nwarps = blockDim.x >> 5;
  const int tr = nwarps * RPW;
  const AttnSmem L = attn_smem<T>(DHP, sb, tr);
  float* qs = reinterpret_cast<float*>(smem + L.q_off);     // [tr][DHP]
  float* sm_m = reinterpret_cast<float*>(smem + L.m_off);   // [tr]
  float* sm_l = reinterpret_cast<float*>(smem + L.l_off);   // [tr]
  float* sm_acc = reinterpret_cast<float*>(smem + L.acc_off);  // [tr][DHP]
  unsigned char* wsm = smem + L.w_off;   // [2][DHP] of T: new K, V rows

  const int h = blockIdx.y;
  const int b = blockIdx.z / tiles;
  const int row0 = (blockIdx.z - b * tiles) * tr;
  const int rows = C * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv = kvl[b];
  const int base = lens[b];

  // the tile's query rows, f32, zero past the last row (and past dh)
  for (int idx = threadIdx.x; idx < tr * DHP; idx += blockDim.x) {
    const int lr = idx / DHP;
    const int d = idx - lr * DHP;
    const int row = row0 + lr;
    float v = 0.f;
    if (row < rows && (!GEN || d < dh)) {
      const int head = h * G + row % G;
      const size_t i = (((size_t)b * C + row / G) * H + head) * dh + d;
      v = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                 : static_cast<const float*>(q)[i];
    }
    qs[idx] = v;
  }
  // GEN, dh < DHP: the staged rows' tails stay zero (copies write only
  // the first dh elements of a row)
  if (GEN && dh < DHP) {
    for (int idx = threadIdx.x; idx < L.kv_bytes / 16; idx += blockDim.x)
      reinterpret_cast<uint4*>(smem)[idx] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // B4: the pool row slot b's new K/V rows go to (0: none)
  const int fl = WRITE ? flat[b] : 0;
  // GEN: a row is rb bytes, copied in units of wu bytes, upr per row
  const int rb = dh * (int)sizeof(T);
  const int wu = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : 2;
  const int upr = rb / wu;

  int nblk = (kv + bs - 1) / bs;           // blocks holding attendable rows
  if (nblk > MB) nblk = MB;
  const int j0 = rank * per;
  const int j1 = min(j0 + per, nblk);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    m[k] = -1e30f;
    l[k] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[k][i] = 0.f;
  }

  if constexpr (!GEN) {
    auto issue = [&](int j, int st) {
      const int blk = tables[(size_t)b * MB + j];
      unsigned char* dst = smem + st * L.stage_bytes;
      for (int idx = threadIdx.x; idx < 2 * bs * CPR; idx += blockDim.x) {
        const int which = idx / (bs * CPR);        // 0 = K, 1 = V
        const int rem = idx - which * bs * CPR;
        const int t = rem / CPR;
        const int c = rem - t * CPR;
        const T* pool = which ? vpool : kpool;
        const T* src = pool + (((size_t)blk * bs + t) * KS + h) * dh +
                       c * EPC;
        cp_async16(dst + (which * bs + t) * L.row_bytes + c * 16, src);
      }
    };

    if (WRITE && fl != 0) {       // B4's rows of head h, in the first group
      for (int idx = threadIdx.x; idx < 2 * CPR; idx += blockDim.x) {
        const int which = idx / CPR;               // 0 = K, 1 = V
        const int c = idx - which * CPR;
        cp_async16(wsm + idx * 16,
                   (which ? nv : nk) + ((size_t)b * KH + h) * dh + c * EPC);
      }
    }
    if (j0 < j1) issue(j0, 0);
    cp_async_commit();
    for (int j = j0; j < j1; ++j) {
      const int st = (j - j0) & 1;
      if (j + 1 < j1) issue(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait1();           // block j's copies (this thread's) landed
      __syncthreads();            // ... and everyone else's
      unsigned char* ks = smem + st * L.stage_bytes;
      const unsigned char* vs = ks + bs * L.row_bytes;
      if (WRITE && fl != 0) {
        const int wrow = fl - tables[(size_t)b * MB + j] * bs;
        if (wrow >= 0 && wrow < bs) {   // B4's row: the new one replaces it
          for (int idx = threadIdx.x; idx < 2 * CPR; idx += blockDim.x) {
            const int which = idx / CPR;
            const int c = idx - which * CPR;
            *reinterpret_cast<uint4*>(ks + (which * bs + wrow) * L.row_bytes
                                      + c * 16) =
                *reinterpret_cast<const uint4*>(wsm + idx * 16);
          }
          __syncthreads();
        }
      }
      attend_piece<T, DPL, RPW>(ks, vs, L.row_bytes, qs, j * bs, bs, kv,
                                base, row0, rows, G, nwarps, warp, lane,
                                scale, m, l, acc);
      __syncthreads();            // stage st is refilled next iteration
    }
  } else {
    // pieces: it -> (column j0 + it / npc, tokens [t0, t0 + cnt) of it);
    // the last column's pieces that start at or past kv are not read
    const int npc = (bs + 31) / 32;
    int n_it = j1 > j0 ? (j1 - j0) * npc : 0;
    if (n_it) n_it -= npc - (min(kv, j1 * bs) - (j1 - 1) * bs + 31) / 32;
    auto issue = [&](int it, int st) {
      const int j = j0 + it / npc;
      const int t0 = (it - (j - j0) * npc) * 32;
      const int cnt = min(sb, bs - t0);
      const int blk = tables[(size_t)b * MB + j];
      unsigned char* dst = smem + st * L.stage_bytes;
      for (int idx = threadIdx.x; idx < 2 * cnt * upr; idx += blockDim.x) {
        const int which = idx / (cnt * upr);       // 0 = K, 1 = V
        const int rem = idx - which * cnt * upr;
        const int t = rem / upr;
        const int u = rem - t * upr;
        const T* pool = which ? vpool : kpool;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            pool + (((size_t)blk * bs + t0 + t) * KS + h) * dh) + u * wu;
        copy_unit_async(dst + (which * sb + t) * L.row_bytes + u * wu, src,
                        wu);
      }
    };

    if (WRITE && fl != 0) {       // B4's rows of head h, in the first group
      for (int idx = threadIdx.x; idx < 2 * upr; idx += blockDim.x) {
        const int which = idx / upr;               // 0 = K, 1 = V
        const int u = idx - which * upr;
        copy_unit_async(wsm + which * DHP * (int)sizeof(T) + u * wu,
                        reinterpret_cast<const unsigned char*>(
                            (which ? nv : nk) + ((size_t)b * KH + h) * dh)
                            + u * wu, wu);
      }
    }
    if (n_it) issue(0, 0);
    cp_async_commit();
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      if (it + 1 < n_it) issue(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait1();           // piece it's copies (this thread's) landed
      __syncthreads();            // ... and everyone else's
      const int j = j0 + it / npc;
      const int t0 = (it - (j - j0) * npc) * 32;
      const int cnt = min(sb, bs - t0);
      unsigned char* ks = smem + st * L.stage_bytes;
      const unsigned char* vs = ks + sb * L.row_bytes;
      if (WRITE && fl != 0) {
        const int wrow = fl - tables[(size_t)b * MB + j] * bs - t0;
        if (wrow >= 0 && wrow < cnt) {  // B4's row: the new one replaces it
          for (int idx = threadIdx.x; idx < 2 * upr; idx += blockDim.x) {
            const int which = idx / upr;
            const int u = idx - which * upr;
            copy_unit(ks + (which * sb + wrow) * L.row_bytes + u * wu,
                      wsm + which * DHP * (int)sizeof(T) + u * wu, wu);
          }
          __syncthreads();
        }
      }
      attend_piece<T, DPL, RPW>(ks, vs, L.row_bytes, qs, j * bs + t0, cnt,
                                kv, base, row0, rows, G, nwarps, warp, lane,
                                scale, m, l, acc);
      __syncthreads();            // stage st is refilled next iteration
    }
  }

  // publish this rank's state (the empty state if it read nothing)
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int lr = warp + k * nwarps;
    if (lane == 0) {
      sm_m[lr] = m[k];
      sm_l[lr] = l[k];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (!GEN || lane + 32 * i < dh)
        sm_acc[lr * DHP + lane + 32 * i] = acc[k][i];
  }
  cluster.sync();

  // B4: every CTA of the cluster has staged its blocks; rank 0 stores the
  // new rows, each thread the units it copied (so no barrier). A rank
  // that staged no block has not waited for its copies yet.
  if (WRITE && fl != 0) {
    cp_async_wait_all();
    if (rank == 0 && row0 == 0) {
      if constexpr (!GEN) {
        for (int idx = threadIdx.x; idx < 2 * CPR; idx += blockDim.x) {
          const int which = idx / CPR;
          const int c = idx - which * CPR;
          *reinterpret_cast<uint4*>((which ? vpool : kpool)
                                    + ((size_t)fl * KH + h) * dh + c * EPC) =
              *reinterpret_cast<const uint4*>(wsm + idx * 16);
        }
      } else {
        for (int idx = threadIdx.x; idx < 2 * upr; idx += blockDim.x) {
          const int which = idx / upr;
          const int u = idx - which * upr;
          copy_unit(reinterpret_cast<unsigned char*>(
                        (which ? vpool : kpool) + ((size_t)fl * KH + h) * dh)
                        + u * wu,
                    wsm + which * DHP * (int)sizeof(T) + u * wu, wu);
        }
      }
    }
  }

  // combine in rank order; this CTA takes every n_split-th output
  for (int e = rank * blockDim.x + threadIdx.x; e < tr * dh;
       e += n_split * blockDim.x) {
    const int lr = e / dh;
    const int d = e - lr * dh;
    const int row = row0 + lr;
    if (row >= rows) break;                    // rows are contiguous in e
    float ms = -1e30f;
    for (int r = 0; r < n_split; ++r)
      ms = fmaxf(ms, *cluster.map_shared_rank(sm_m + lr, r));
    float ls = 0.f, as = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float w = expf(__fsub_rn(*cluster.map_shared_rank(sm_m + lr, r),
                                     ms));
      ls = __fadd_rn(ls, __fmul_rn(*cluster.map_shared_rank(sm_l + lr, r), w));
      as = __fadd_rn(as, __fmul_rn(
          *cluster.map_shared_rank(sm_acc + lr * DHP + d, r), w));
    }
    const int head = h * G + row % G;
    const size_t o = (((size_t)b * C + row / G) * H + head) * dh + d;
    const float y = __fdiv_rn(as, fmaxf(ls, 1e-30f));
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[o] = y;
  }
  cluster.sync();                 // peers may still read this CTA's state
}

template <typename T, int DPL, int RPW, bool WRITE, bool GEN, bool STRIDED>
int launch_attn(const AttnArgs& a, int n_split, int warps,
                cudaStream_t stream) {
  const int tr = warps * RPW;
  const int tiles = (a.C * a.G + tr - 1) / tr;
  const int sb = GEN ? (a.bs < 32 ? a.bs : 32) : a.bs;
  const size_t smem = (size_t)attn_smem<T>(DPL * 32, sb, tr).total;
  static size_t cap = 48 * 1024;   // raised once, not per (captured) launch
  if (smem > cap) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T, DPL, RPW, WRITE, GEN, STRIDED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap = smem;
  }
  if ((size_t)a.B * tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, a.KH, a.B * tiles);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_attn_kernel<T, DPL, RPW, WRITE, GEN, STRIDED>, a.q,
      static_cast<T*>(a.k), static_cast<T*>(a.v),
      static_cast<const T*>(a.nk), static_cast<const T*>(a.nv), a.flat,
      a.tables, a.lens, a.kvl, a.out, a.q_bf16, a.out_bf16, a.C, a.H, a.KH,
      a.G, a.dh, a.bs, a.MB, a.per, tiles, a.scale, a.KS);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Up to 8 query rows: one row per warp; more: 8 warps of 4 rows each.
template <typename T, int DPL, bool WRITE, bool GEN, bool STRIDED>
int launch_rows(const AttnArgs& a, int n_split, cudaStream_t stream) {
  const int rows = a.C * a.G;
  if (rows <= kMaxWarps)
    return launch_attn<T, DPL, 1, WRITE, GEN, STRIDED>(a, n_split, rows,
                                                       stream);
  return launch_attn<T, DPL, 4, WRITE, GEN, STRIDED>(a, n_split, kMaxWarps,
                                                     stream);
}

// B3 alone on a head slice (KS > KH), B3 alone, or B3 with B4's write.
template <typename T, int DPL, bool GEN>
int launch_write(const AttnArgs& a, int n_split, cudaStream_t stream) {
  if (a.KS != a.KH)
    return launch_rows<T, DPL, false, GEN, true>(a, n_split, stream);
  return a.flat ? launch_rows<T, DPL, true, GEN, false>(a, n_split, stream)
                : launch_rows<T, DPL, false, GEN, false>(a, n_split, stream);
}

// The fast case (dh in {32, 64, 128, 256}, bs <= 32) and the GEN instances
// of every other 1 <= dh <= 256 and bs >= 1, DPL = ceil(dh / 32).
template <typename T>
int dispatch_dh(const AttnArgs& a, int n_split, cudaStream_t stream) {
  if (a.bs <= 32) {
    switch (a.dh) {
      case 32: return launch_write<T, 1, false>(a, n_split, stream);
      case 64: return launch_write<T, 2, false>(a, n_split, stream);
      case 128: return launch_write<T, 4, false>(a, n_split, stream);
      case 256: return launch_write<T, 8, false>(a, n_split, stream);
      default: break;
    }
  }
  switch ((a.dh + 31) / 32) {
    case 1: return launch_write<T, 1, true>(a, n_split, stream);
    case 2: return launch_write<T, 2, true>(a, n_split, stream);
    case 3: return launch_write<T, 3, true>(a, n_split, stream);
    case 4: return launch_write<T, 4, true>(a, n_split, stream);
    case 5: return launch_write<T, 5, true>(a, n_split, stream);
    case 6: return launch_write<T, 6, true>(a, n_split, stream);
    case 7: return launch_write<T, 7, true>(a, n_split, stream);
    case 8: return launch_write<T, 8, true>(a, n_split, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B3, and B4 folded into it. pool_bf16 / q_bf16 / out_bf16: 1 for bf16,
// 0 for f32. Any 1 <= dh <= 256 and bs >= 1. The table columns split over
// n_split cluster ranks of `per` columns each (the wrapper's attn_splits,
// which the plain version follows). flat null: B3 alone; else (C = 1
// only) slot b's new rows nk, nv [B, 1, KH, dh] (pool dtype, 16-byte
// aligned) go to pool row flat[b] unless it is 0, and the attention reads
// them there. KS: the pools' row stride in heads; KS > KH reads the KH
// heads from k, v of pools with KS heads a row (a head slice, in place;
// B3 alone, flat null).
int paged_attn_launch(int pool_bf16, int q_bf16, int out_bf16, const void* q,
                      void* k, void* v, const void* nk, const void* nv,
                      const int* flat, const int* tables, const int* lens,
                      const int* kvl, void* out, int B, int C, int H, int KH,
                      int KS, int dh, int bs, int MB, int n_split, int per,
                      float scale, cudaStream_t stream) {
  if (B <= 0 || C <= 0) return 0;
  if (bs < 1 || dh < 1 || dh > 256 || KH <= 0 || H % KH || MB < 1 ||
      n_split < 1 || n_split > kMaxSplit || per < 1 || n_split * per < MB ||
      KS < KH || (flat && (C != 1 || !nk || !nv || KS != KH)))
    return (int)cudaErrorInvalidValue;
  const AttnArgs a = {q, k, v, nk, nv, flat, tables, lens, kvl, out, q_bf16,
                      out_bf16, B, C, H, KH, H / KH, dh, bs, MB, per, KS,
                      scale};
  if (pool_bf16) return dispatch_dh<__nv_bfloat16>(a, n_split, stream);
  return dispatch_dh<float>(a, n_split, stream);
}

}  // extern "C"
