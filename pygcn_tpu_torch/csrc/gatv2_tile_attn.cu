// Kernels B7, B8 and B9 for Hopper (sm_90a): GATv2 attention over BCSR tiles.
//
// For a tile edge u -> v (tile[v][u] != 0; the tile's value is never
// multiplied in), head h and pre_f = sl[u, hF+f] + sr[v, hF+f]:
//   e = sum_f a[h,f] leaky(pre_f), summed in the order f = 0 .. F-1.
//
//   B7 (replaces pygcn_tpu/ops/pallas/gat_tile_attn.py:_v2_fwd_kernel):
//      m[v,h]   = max over v's tile edges of e (NEG where v has none)
//      den[v,h] = sum_u exp(e - m),  num[v, hF:(h+1)F] = sum_u exp(e - m) sl[u, hF:(h+1)F]
//   B8 (replaces _v2_bwd_recv_kernel), over the forward tiles, with
//      p = exp(e - m[v,h]) and de = p (sl[u,h.] . dnum[v,h.] + dden[v,h]):
//      dsr[v, hF+f]    = sum_u de a[h,f] leaky'(pre_f)
//      dapart[v, hF+f] = sum_u de leaky(pre_f)      (da = dapart summed over v, outside)
//   B9 (replaces _v2_bwd_send_kernel), over the transpose tiles (rows are
//      senders u, columns receivers v):
//      dsl[u, hF+f] = sum_v p dnum[v, hF+f] + sum_v de a[h,f] leaky'(pre_f)
//   with leaky'(pre) = pre >= 0 ? 1 : slope (the derivative jax.nn.leaky_relu has).
//
// Bound on an H100 SXM at the ogbn-arxiv hybrid (2863 f32 tiles, 3.1M tile
// edges, N = 169,343): each launch must read the tiles as stored (0.19 GB) plus
// the [N, H F] operand rows and outputs, 0.27-0.42 GB in all, about
// 0.08-0.12 ms at 3.35 TB/s; the 7F+4 to 13F+4 operations per tile edge and
// head take under 0.05 ms at the 67 TFLOP/s f32 rate: bound by bytes.
//
// B7's design (gatv2_fwd_item_kernel) is B3's (gat_tile_attn.cu): work items
// of at most C tiles of a block row (B1's schedule), one CTA of 128 threads
// per item for all heads; each tile's mask decoded once into shared memory;
// each thread walking only its own row's edges; a row of one item writing its
// outputs, the items of a longer row writing partials that the last to arrive
// merges in item order (the flash merge). Per head the CTA stages the head's
// a[h, :F] and, per tile, the senders' sl, all F columns: the logit needs
// every f before any softmax weight exists. It takes the online softmax one
// edge at a time: the logit costs F FMAs and LeakyReLUs, so it is evaluated
// once, and a row whose running max rises rescales den and num by
// corr = exp(m_old - e) right there (0, with den and num still 0, for a row
// at NEG). A head wider than 64 runs the walk once per 64-column slab of num,
// recomputing the logits (the same bits each time).
//
// B8 and B9 (not redesigned): one CTA of 128 threads owns one (head, block
// row), blockIdx.x = block_row * H + head, and loops over the row's tiles;
// thread i owns row i of the block; the warp walks the columns that any of its
// rows needs (gat_tile_common.cuh: for_columns); every output is written once,
// with no atomics. A block row without tiles writes zero gradients. Per tile
// the CTA stages the column side's rows of its head: B8 the senders' sl; B9
// the receivers' sr and dnum, with their m and dden. Heads up to 40 wide (B9:
// up to 64) run the first design: the own row (B8: sr; B9: sl) and the
// outputs (B8: dsr and dapart; B9: dsl) in registers, B8's own dnum transposed
// in shared memory. Wider heads run one kernel for any F, whose outputs are
// accumulated one 64-column slab at a time, the tile loop running once per
// slab.
//
// Own rows in registers up to F = 40 (B7 and B8; B9 up to 64: at F = 48 and
// 64 its register kernel ran 25-35% faster than the wide one, B7's and B8's
// no faster, apps/time_gat.py on an H100); above it, in shared memory
// (row-major at a padded stride, so the lanes' 16-byte reads of their own
// rows hit distinct banks), every row staged with all F columns (the logit
// and the dot products need every f) and the loops over F in chunks of 16.
// Shared memory per CTA then grows with F, in rows of F rounded up to 16 plus
// 4 floats: B7 256 rows and C x 2 KB of mask words, up to the card's 227 KB at
// F = 208; B8 and B9 384 rows, up to F = 144. Wider heads fail to launch
// there (an error, never a plain fallback).
//
// Precision: expf (not __expf) and f32 FMA, no TF32; the logit's terms are
// added in the order f = 0 .. F-1. Ragged shapes are masked in the kernel:
// operand rows past n and columns past F read as zero (a zero a[h,f] adds
// nothing to e) and output rows past n or columns past F are not written.
// Plain C interface, loaded with ctypes.

#include "gat_tile_common.cuh"

namespace {

using namespace gat_tile;

__device__ __forceinline__ float dleaky(float pre, float slope) { return pre >= 0.f ? 1.f : slope; }

// Widths up to 40 keep the block's own row in registers (the loops over F
// unrolled at the compiled width FP); wider heads, on the width-64 kernels,
// read it from shared memory in chunks of CH columns. B9 keeps it in
// registers up to SEND_REG_F.
constexpr int CH = 16;
constexpr int MAX_REG_F = 40;
constexpr int SEND_REG_F = SLAB;
// Rows of the block's own operand rows kept in shared memory: none when they
// are in registers.
__host__ __device__ constexpr int own_rows(int fp) { return fp <= MAX_REG_F ? 0 : TM; }

// Columns of a staged row: FP when the own row is in registers (F <= FP),
// else F rounded up to CH (zero past F).
__host__ __device__ constexpr int staged_width(int f) {
  return width_of(f) <= MAX_REG_F ? width_of(f) : (f + CH - 1) / CH * CH;
}

// One step of the v2 logit: e += a leaky(o + x) for four columns, in order.
__device__ __forceinline__ float logit4(float e, float4 a, float4 o, float4 x, float slope) {
  e = fmaf(a.x, leaky(o.x + x.x, slope), e);
  e = fmaf(a.y, leaky(o.y + x.y, slope), e);
  e = fmaf(a.z, leaky(o.z + x.z, slope), e);
  return fmaf(a.w, leaky(o.w + x.w, slope), e);
}
__device__ __forceinline__ float dot4(float d, float4 a, float4 b) {
  d = fmaf(a.x, b.x, d);
  d = fmaf(a.y, b.y, d);
  d = fmaf(a.z, b.z, d);
  return fmaf(a.w, b.w, d);
}
__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The v2 logit of one slot, sum_f a[f] leaky(own[f] + xj[f]) in the order
// f = 0 .. F-1: with the own row in registers (FP columns) or in shared
// memory (w columns, a multiple of CH).
template <int FP>
__device__ __forceinline__ float logit_reg(const float* a_sh, const float own[FP],
                                           const float* xj, float slope) {
  float e = 0.f;
#pragma unroll
  for (int q = 0; q < FP / 4; ++q)
    e = logit4(e, lds4(a_sh + 4 * q), make_float4(own[4 * q], own[4 * q + 1], own[4 * q + 2],
                                                  own[4 * q + 3]),
               lds4(xj + 4 * q), slope);
  return e;
}
__device__ __forceinline__ float logit_sh(const float* a_sh, const float* own, const float* xj,
                                          int w, float slope) {
  float e = 0.f;
  for (int c = 0; c < w; c += CH) {
#pragma unroll
    for (int q = 0; q < CH / 4; ++q)
      e = logit4(e, lds4(a_sh + c + 4 * q), lds4(own + c + 4 * q), lds4(xj + c + 4 * q), slope);
  }
  return e;
}

// sum_f x[f] y[f] over w columns (a multiple of CH), f in order.
__device__ __forceinline__ float dot_sh(const float* x, const float* y, int w) {
  float d = 0.f;
  for (int c = 0; c < w; c += CH) {
#pragma unroll
    for (int q = 0; q < CH / 4; ++q) d = dot4(d, lds4(x + c + 4 * q), lds4(y + c + 4 * q));
  }
  return d;
}

// A compiler barrier: shared-memory values read before it are read again after
// it rather than kept in registers (the staged row of a slot, and a[h, :],
// which is invariant across the column loop and would otherwise be hoisted).
// At F = 40 it took B8 from 255 registers with a spill to 246 without one
// (ptxas -v, sm_90a).
__device__ __forceinline__ void reread_shared() { asm volatile("" ::: "memory"); }

// Row `row` of the head's F columns of x [n, H*F] into dst[FP], zero past n and F.
template <int FP>
__device__ __forceinline__ void load_row(float dst[FP], const float* x, long long row, int n,
                                         int hf, int head, int f) {
#pragma unroll
  for (int k = 0; k < FP; ++k)
    dst[k] = (row < n && k < f) ? x[row * hf + static_cast<long long>(head) * f + k] : 0.f;
}

// a[head, :f] into a_sh[0 .. len), zero past f.
__device__ __forceinline__ void stage_a(float* a_sh, const float* a, int head, int f, int len) {
  for (int k = threadIdx.x; k < len; k += THREADS) a_sh[k] = k < f ? a[head * f + k] : 0.f;
}

// B7. blockIdx.x is a work item; `max_tiles` (C) sizes the shared memory and
// `group` tiles' sl rows are staged at once.
template <int FP>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_item_kernel(const void* __restrict__ tiles, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ items,
                      const float* __restrict__ sl, const float* __restrict__ sr,
                      const float* __restrict__ a, float* __restrict__ num_out,
                      float* __restrict__ den_out, float* __restrict__ m_out,
                      float* __restrict__ ws, int* __restrict__ counters, int n_slots, int n,
                      int h, int f, int max_tiles, int group, float slope) {
  constexpr bool REG = FP <= MAX_REG_F;
  const int W = staged_width(f), S = slab_stride(W);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                  // [C][TM]: own words
  float* a_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [W]
  float* own_sh = a_sh + W;                        // [TM][S]: own sr rows (wide heads)
  float* sl_sh = own_sh + own_rows(FP) * S;        // [group][TK][S], then FP spare
  int* cols_sh = reinterpret_cast<int*>(sl_sh + group * TK * S + FP);  // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long row0 = static_cast<long long>(it.row) * TM, v = row0 + i;
  const Partials parts(ws, n_slots, h, hf);

  if (i < nt) cols_sh[i] = block_cols[it.begin + i];
  for (int t = 0; t < nt; ++t) {
    uint32_t w[4];
    mask_words(tile_ptr(tiles, bf16, it.begin + t), bf16, w);
    mask_sh[t * TM + i] = make_uint4(w[0], w[1], w[2], w[3]);  // read by this thread only
  }
  const float* own = own_sh + i * S;
  for (int head = 0; head < h; ++head) {
    float srv[FP];
    if constexpr (REG) load_row<FP>(srv, sr, v, n, hf, head, f);
    for (int s0 = 0; s0 < f; s0 += FP) {
      const int fw = min(FP, f - s0);
      float m = NEG, den = 0.f, acc[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) acc[k] = 0.f;
      for (int g0 = 0; g0 < nt; g0 += group) {
        const int gn = min(group, nt - g0);
        __syncthreads();  // the previous senders, a and own rows are no longer read
        if (s0 == 0 && g0 == 0) {
          stage_a(a_sh, a, head, f, W);
          if constexpr (!REG) stage_rows(own_sh, S, W, sr, row0, n, hf, head * f, f);
        }
        stage_tiles(sl_sh, S, W, sl, cols_sh + g0, gn, n, hf, head * f, f);
        __syncthreads();
        for (int t = g0; t < g0 + gn; ++t) {
          const float* st = sl_sh + (t - g0) * TK * S;
          for_own_edges(mask_sh[t * TM + i], [&](int j) {
            const float* xj = st + j * S;
            float e;
            if constexpr (REG) {
              e = logit_reg<FP>(a_sh, srv, xj, slope);
            } else {
              e = logit_sh(a_sh, own, xj, W, slope);
            }
            if (e > m) {
              const float corr = expf(m - e);  // from NEG: 0, with den and num still 0
              den *= corr;
#pragma unroll
              for (int k = 0; k < FP; ++k) acc[k] *= corr;
              m = e;
            }
            const float p = expf(e - m);
            den += p;
#pragma unroll
            for (int q = 0; q < FP / 4; ++q) {
              const float4 x = lds4(xj + s0 + 4 * q);
              acc[4 * q + 0] = fmaf(p, x.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(p, x.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(p, x.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(p, x.w, acc[4 * q + 3]);
            }
          });
        }
      }
      put_softmax<FP>(it, parts, num_out, den_out, m_out, v, n, h, hf, head, f, s0, fw, acc, den,
                      m);
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    merge_parts(it, parts, num_out, den_out, m_out, n, h, hf);
}

// B8 and B9 for heads up to 40 wide (B9: up to 64): the own row and the
// outputs in registers, the column side staged at stride FP, B8's
// own dnum transposed in shared memory ([F][128], so the warp's 32 lanes read
// 32 banks).
template <int FP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_recv_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                      const int* __restrict__ block_row_ptr, const float* __restrict__ sl,
                      const float* __restrict__ sr, const float* __restrict__ a,
                      const float* __restrict__ m_in, const float* __restrict__ dnum,
                      const float* __restrict__ dden, float* __restrict__ dsr_out,
                      float* __restrict__ dapart_out, int n, int h, int f, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sl_sh = reinterpret_cast<float*>(smem);  // [TK][FP]: the tile's senders
  float* dn_sh = sl_sh + TK * FP;     // [FP][TM]: each thread's own dnum row, transposed
  float* a_sh = dn_sh + FP * TM;      // [FP]
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f;
  const int i = threadIdx.x;
  const long long v = static_cast<long long>(br) * TM + i;
  float srv[FP], gsr[FP], gap[FP];
  load_row<FP>(srv, sr, v, n, hf, head, f);
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    dn_sh[k * TM + i] =
        (v < n && k < f) ? dnum[v * hf + static_cast<long long>(head) * f + k] : 0.f;
    gsr[k] = 0.f;
    gap[k] = 0.f;
  }
  stage_a(a_sh, a, head, f, FP);
  const float mv = node(m_in, v, n, h, head);
  const float dd = node(dden, v, n, h, head);

  const int t_end = block_row_ptr[br + 1];
  for (int t = block_row_ptr[br]; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;
    __syncthreads();
    stage_rows(sl_sh, FP, FP, sl, col0, n, hf, head * f, f);
    uint32_t w[4];
    mask_words(tile_ptr(tiles, bf16, t), bf16, w);
    __syncthreads();

    for_columns(w, [&](int j, bool on) {
      const float4* s4 = reinterpret_cast<const float4*>(sl_sh + j * FP);
      const float4* a4 = reinterpret_cast<const float4*>(a_sh);
      const float e = logit_reg<FP>(a_sh, srv, sl_sh + j * FP, slope);
      float gdot = 0.f;
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 s = s4[q];
        gdot = fmaf(dn_sh[(4 * q + 0) * TM + i], s.x, gdot);
        gdot = fmaf(dn_sh[(4 * q + 1) * TM + i], s.y, gdot);
        gdot = fmaf(dn_sh[(4 * q + 2) * TM + i], s.z, gdot);
        gdot = fmaf(dn_sh[(4 * q + 3) * TM + i], s.w, gdot);
      }
      const float p = on ? expf(e - mv) : 0.f;
      const float de = p * (gdot + dd);
      reread_shared();
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 s = s4[q], av = a4[q];
        const float s_[4] = {s.x, s.y, s.z, s.w}, a_[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * q + c;
          const float pre = srv[k] + s_[c];
          gsr[k] = fmaf(de, a_[c] * dleaky(pre, slope), gsr[k]);
          gap[k] = fmaf(de, leaky(pre, slope), gap[k]);
        }
      }
    });
  }
  if (v < n) {
    const long long o = v * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) {
        dsr_out[o + k] = gsr[k];
        dapart_out[o + k] = gap[k];
      }
  }
}

template <int FP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_send_kernel(const void* __restrict__ tiles_t, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ block_row_ptr,
                      const float* __restrict__ sl, const float* __restrict__ sr,
                      const float* __restrict__ a, const float* __restrict__ m_in,
                      const float* __restrict__ dnum, const float* __restrict__ dden,
                      float* __restrict__ dsl_out, int n, int h, int f, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sr_sh = reinterpret_cast<float*>(smem);  // [TK][FP]: the tile's receivers
  float* dn_sh = sr_sh + TK * FP;     // [TK][FP]
  float* m_sh = dn_sh + TK * FP;      // [TK]
  float* dd_sh = m_sh + TK;           // [TK]
  float* a_sh = dd_sh + TK;           // [FP]
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f;
  const long long u = static_cast<long long>(br) * TM + threadIdx.x;  // sender
  float slu[FP], g[FP];
  load_row<FP>(slu, sl, u, n, hf, head, f);
#pragma unroll
  for (int k = 0; k < FP; ++k) g[k] = 0.f;
  stage_a(a_sh, a, head, f, FP);

  const int t_end = block_row_ptr[br + 1];
  for (int t = block_row_ptr[br]; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;  // receivers
    __syncthreads();
    m_sh[threadIdx.x] = node(m_in, col0 + threadIdx.x, n, h, head);
    dd_sh[threadIdx.x] = node(dden, col0 + threadIdx.x, n, h, head);
    stage_rows(sr_sh, FP, FP, sr, col0, n, hf, head * f, f);
    stage_rows(dn_sh, FP, FP, dnum, col0, n, hf, head * f, f);
    uint32_t w[4];
    mask_words(tile_ptr(tiles_t, bf16, t), bf16, w);
    __syncthreads();

    for_columns(w, [&](int j, bool on) {
      const float4* x4 = reinterpret_cast<const float4*>(sr_sh + j * FP);
      const float4* d4 = reinterpret_cast<const float4*>(dn_sh + j * FP);
      const float4* a4 = reinterpret_cast<const float4*>(a_sh);
      const float e = logit_reg<FP>(a_sh, slu, sr_sh + j * FP, slope);
      float gdot = 0.f;
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 d = d4[q];
        gdot = fmaf(slu[4 * q + 0], d.x, gdot);
        gdot = fmaf(slu[4 * q + 1], d.y, gdot);
        gdot = fmaf(slu[4 * q + 2], d.z, gdot);
        gdot = fmaf(slu[4 * q + 3], d.w, gdot);
      }
      const float p = on ? expf(e - m_sh[j]) : 0.f;
      const float de = p * (gdot + dd_sh[j]);
      reread_shared();
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 x = x4[q], d = d4[q], av = a4[q];
        const float x_[4] = {x.x, x.y, x.z, x.w}, d_[4] = {d.x, d.y, d.z, d.w};
        const float a_[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * q + c;
          const float pre = slu[k] + x_[c];
          g[k] = fmaf(p, d_[c], g[k]);
          g[k] = fmaf(de, a_[c] * dleaky(pre, slope), g[k]);
        }
      }
    });
  }
  if (u < n) {
    float* dst = dsl_out + u * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) dst[k] = g[k];
  }
}

// B8 and B9 for wider heads, any F: every operand row in shared memory at a
// padded stride, all F columns (the logit and dot product need every f), the
// loops over F in chunks of CH, the outputs one 64-column slab at a time.
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_recv_wide_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                      const int* __restrict__ block_row_ptr, const float* __restrict__ sl,
                      const float* __restrict__ sr, const float* __restrict__ a,
                      const float* __restrict__ m_in, const float* __restrict__ dnum,
                      const float* __restrict__ dden, float* __restrict__ dsr_out,
                      float* __restrict__ dapart_out, int n, int h, int f, float slope) {
  constexpr int FP = SLAB;
  const int W = staged_width(f), S = slab_stride(W);
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_sh = reinterpret_cast<float*>(smem);  // [W + FP]
  float* sr_sh = a_sh + W + FP;                  // [TM][S]: own sr rows
  float* dn_sh = sr_sh + TM * S;                 // [TM][S]: own dnum rows
  float* sl_sh = dn_sh + TM * S;                 // [TK][S]: the tile's senders, then FP spare
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f, i = threadIdx.x;
  const long long row0 = static_cast<long long>(br) * TM, v = row0 + i;
  stage_a(a_sh, a, head, f, W + FP);
  stage_rows(sr_sh, S, W, sr, row0, n, hf, head * f, f);
  stage_rows(dn_sh, S, W, dnum, row0, n, hf, head * f, f);
  const float mv = node(m_in, v, n, h, head);
  const float dd = node(dden, v, n, h, head);
  const float *own_sr = sr_sh + i * S, *own_dn = dn_sh + i * S;

  const int t_begin = block_row_ptr[br], t_end = block_row_ptr[br + 1];
  for (int s0 = 0; s0 < f; s0 += FP) {
    const int fw = min(FP, f - s0);
    float gsr[FP], gap[FP];
#pragma unroll
    for (int k = 0; k < FP; ++k) gsr[k] = gap[k] = 0.f;
    for (int t = t_begin; t < t_end; ++t) {
      __syncthreads();  // the previous tile's senders are no longer read
      stage_rows(sl_sh, S, W, sl, static_cast<long long>(block_cols[t]) * TK, n, hf, head * f, f);
      uint32_t w[4];
      mask_words(tile_ptr(tiles, bf16, t), bf16, w);
      __syncthreads();

      for_columns(w, [&](int j, bool on) {
        const float* xj = sl_sh + j * S;
        const float e = logit_sh(a_sh, own_sr, xj, W, slope);
        const float gdot = dot_sh(own_dn, xj, W);
        const float p = on ? expf(e - mv) : 0.f;
        const float de = p * (gdot + dd);
#pragma unroll
        for (int q = 0; q < FP / 4; ++q) {
          const float4 s = lds4(xj + s0 + 4 * q), av = lds4(a_sh + s0 + 4 * q);
          const float s_[4] = {s.x, s.y, s.z, s.w}, a_[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = 4 * q + c;
            const float pre = own_sr[s0 + k] + s_[c];
            gsr[k] = fmaf(de, a_[c] * dleaky(pre, slope), gsr[k]);
            gap[k] = fmaf(de, leaky(pre, slope), gap[k]);
          }
        }
      });
    }
    if (v < n) {
      const long long o = v * hf + static_cast<long long>(head) * f + s0;
#pragma unroll
      for (int k = 0; k < FP; ++k)
        if (k < fw) {
          dsr_out[o + k] = gsr[k];
          dapart_out[o + k] = gap[k];
        }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gatv2_bwd_send_wide_kernel(const void* __restrict__ tiles_t, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ block_row_ptr,
                      const float* __restrict__ sl, const float* __restrict__ sr,
                      const float* __restrict__ a, const float* __restrict__ m_in,
                      const float* __restrict__ dnum, const float* __restrict__ dden,
                      float* __restrict__ dsl_out, int n, int h, int f, float slope) {
  constexpr int FP = SLAB;
  const int W = staged_width(f), S = slab_stride(W);
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_sh = reinterpret_cast<float*>(smem);  // [W + FP]
  float* sl_sh = a_sh + W + FP;                  // [TM][S]: own sl rows
  float* sr_sh = sl_sh + TM * S;                 // [TK][S]: the tile's receivers
  float* dn_sh = sr_sh + TK * S;                 // [TK][S], then FP spare
  float* m_sh = dn_sh + TK * S + FP;             // [TK]
  float* dd_sh = m_sh + TK;                      // [TK]
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f, i = threadIdx.x;
  const long long row0 = static_cast<long long>(br) * TM, u = row0 + i;  // sender
  stage_a(a_sh, a, head, f, W + FP);
  stage_rows(sl_sh, S, W, sl, row0, n, hf, head * f, f);
  const float* own = sl_sh + i * S;

  const int t_begin = block_row_ptr[br], t_end = block_row_ptr[br + 1];
  for (int s0 = 0; s0 < f; s0 += FP) {
    const int fw = min(FP, f - s0);
    float g[FP];
#pragma unroll
    for (int k = 0; k < FP; ++k) g[k] = 0.f;
    for (int t = t_begin; t < t_end; ++t) {
      const long long col0 = static_cast<long long>(block_cols[t]) * TK;  // receivers
      __syncthreads();  // the previous tile's receivers are no longer read
      m_sh[i] = node(m_in, col0 + i, n, h, head);
      dd_sh[i] = node(dden, col0 + i, n, h, head);
      stage_rows(sr_sh, S, W, sr, col0, n, hf, head * f, f);
      stage_rows(dn_sh, S, W, dnum, col0, n, hf, head * f, f);
      uint32_t w[4];
      mask_words(tile_ptr(tiles_t, bf16, t), bf16, w);
      __syncthreads();

      for_columns(w, [&](int j, bool on) {
        const float *xj = sr_sh + j * S, *dj = dn_sh + j * S;
        const float e = logit_sh(a_sh, own, xj, W, slope);
        const float gdot = dot_sh(own, dj, W);
        const float p = on ? expf(e - m_sh[j]) : 0.f;
        const float de = p * (gdot + dd_sh[j]);
#pragma unroll
        for (int q = 0; q < FP / 4; ++q) {
          const float4 x = lds4(xj + s0 + 4 * q), d = lds4(dj + s0 + 4 * q);
          const float4 av = lds4(a_sh + s0 + 4 * q);
          const float x_[4] = {x.x, x.y, x.z, x.w}, d_[4] = {d.x, d.y, d.z, d.w};
          const float a_[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = 4 * q + c;
            const float pre = own[s0 + k] + x_[c];
            g[k] = fmaf(p, d_[c], g[k]);
            g[k] = fmaf(de, a_[c] * dleaky(pre, slope), g[k]);
          }
        }
      });
    }
    if (u < n) {
      float* dst = dsl_out + u * hf + static_cast<long long>(head) * f + s0;
#pragma unroll
      for (int k = 0; k < FP; ++k)
        if (k < fw) dst[k] = g[k];
    }
  }
}

// Each kernel's dynamic shared memory at per-head width f (compiled width
// fp) and, for B7, C = max_tiles.
int fwd_group(int f, int max_tiles) {
  return tile_group(sizeof(float) * TK * slab_stride(staged_width(f)), max_tiles);
}
size_t fwd_smem(int f, int fp, int max_tiles) {
  const int w = staged_width(f);
  return static_cast<size_t>(max_tiles) * (TM * sizeof(uint4) + sizeof(int)) +
         sizeof(float) * (w + (own_rows(fp) + static_cast<size_t>(fwd_group(f, max_tiles)) * TK) *
                                  slab_stride(w) +
                          fp);
}
size_t recv_smem(int fp) { return sizeof(float) * (TK * fp + fp * TM + fp); }
size_t send_smem(int fp) { return sizeof(float) * (2 * TK * fp + 2 * TK + fp); }
size_t recv_wide_smem(int f) {
  const int w = staged_width(f);
  return sizeof(float) * (w + 2 * SLAB + 3 * TM * slab_stride(w));
}
size_t send_wide_smem(int f) { return recv_wide_smem(f) + sizeof(float) * 2 * TK; }

// The narrow widths' pick.
template <typename Kernel>
Kernel pick_narrow(int f, Kernel k4, Kernel k8, Kernel k16, Kernel k32, Kernel k40) {
  return f <= 4 ? k4 : f <= 8 ? k8 : f <= 16 ? k16 : f <= 32 ? k32 : k40;
}

}  // namespace

extern "C" {

// Tile shape and the ints of one work item of B7.
int gatv2_tile_attn_config(int* tm, int* tk, int* item_ints) {
  *tm = TM;
  *tk = TK;
  *item_ints = ITEM_INTS;
  return 0;
}

// B7, on B3's schedule and workspace (gat_tile_attn.cu: gat_tile_fwd).
// Returns the CUDA error of the launch (0 on success).
int gatv2_tile_fwd(const void* tiles, const void* block_cols, const void* items, const void* sl,
                   const void* sr, const void* a, void* num, void* den, void* m, void* ws,
                   void* counters, int n_items, int n_slots, int n, int h, int f, int max_tiles,
                   int tile_bf16, float slope, void* stream) {
  if (f < 1 || max_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_TILE_WIDTHS(gatv2_fwd_item_kernel)), dim3(n_items),
                fwd_smem(f, width_of(f), max_tiles), stream, tiles, tile_bf16,
                static_cast<const int*>(block_cols), static_cast<const int*>(items),
                static_cast<const float*>(sl), static_cast<const float*>(sr),
                static_cast<const float*>(a), static_cast<float*>(num), static_cast<float*>(den),
                static_cast<float*>(m), static_cast<float*>(ws), static_cast<int*>(counters),
                n_slots, n, h, f, max_tiles, fwd_group(f, max_tiles), slope);
}

// B8 over the forward tiles.
int gatv2_tile_bwd_recv(const void* tiles, const void* block_cols, const void* block_row_ptr,
                        const void* sl, const void* sr, const void* a, const void* m,
                        const void* dnum, const void* dden, void* dsr, void* dapart,
                        int n_block_rows, int n, int h, int f, int tile_bf16, float slope,
                        void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel, size_t smem) {
    return launch(kernel, grid_of(n_block_rows, h), smem, stream, tiles, tile_bf16,
                  static_cast<const int*>(block_cols), static_cast<const int*>(block_row_ptr),
                  static_cast<const float*>(sl), static_cast<const float*>(sr),
                  static_cast<const float*>(a), static_cast<const float*>(m),
                  static_cast<const float*>(dnum), static_cast<const float*>(dden),
                  static_cast<float*>(dsr), static_cast<float*>(dapart), n, h, f, slope);
  };
  if (f > MAX_REG_F) return go(gatv2_bwd_recv_wide_kernel, recv_wide_smem(f));
  return go(pick_narrow(f, gatv2_bwd_recv_kernel<4>, gatv2_bwd_recv_kernel<8>,
                        gatv2_bwd_recv_kernel<16>, gatv2_bwd_recv_kernel<32>,
                        gatv2_bwd_recv_kernel<40>),
            recv_smem(width_of(f)));
}

// B9 over the transpose tiles (block rows are senders).
int gatv2_tile_bwd_send(const void* tiles_t, const void* block_cols, const void* block_row_ptr,
                        const void* sl, const void* sr, const void* a, const void* m,
                        const void* dnum, const void* dden, void* dsl, int n_block_rows, int n,
                        int h, int f, int tile_bf16, float slope, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel, size_t smem) {
    return launch(kernel, grid_of(n_block_rows, h), smem, stream, tiles_t, tile_bf16,
                  static_cast<const int*>(block_cols), static_cast<const int*>(block_row_ptr),
                  static_cast<const float*>(sl), static_cast<const float*>(sr),
                  static_cast<const float*>(a), static_cast<const float*>(m),
                  static_cast<const float*>(dnum), static_cast<const float*>(dden),
                  static_cast<float*>(dsl), n, h, f, slope);
  };
  if (f > SEND_REG_F) return go(gatv2_bwd_send_wide_kernel, send_wide_smem(f));
  if (f > MAX_REG_F) return go(gatv2_bwd_send_kernel<SLAB>, send_smem(SLAB));
  return go(pick_narrow(f, gatv2_bwd_send_kernel<4>, gatv2_bwd_send_kernel<8>,
                        gatv2_bwd_send_kernel<16>, gatv2_bwd_send_kernel<32>,
                        gatv2_bwd_send_kernel<40>),
            send_smem(width_of(f)));
}

}  // extern "C"
