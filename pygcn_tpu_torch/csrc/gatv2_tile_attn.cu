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
// recomputing the logits (the same bits each time). Its rows of all F
// columns fit an H100's 227 KB up to F = 208 (MAX_STAGED_F); wider heads run
// gatv2_fwd_chunk_kernel (below).
//
// B8 and B9 (gatv2_bwd_{recv,send}_item_kernel) run on the same work items:
// B8 over the forward tiles, sharing B7's schedule and arrival counters
// (the wrapper launches B7 and B8 one after the other on one stream, never
// together), B9 over the transpose tiles on their own. One CTA per item for
// all heads; each tile's mask decoded once; each thread walks its own row's
// edges (B8: the receiver v, holding sr_v and dnum_v; B9: the sender u,
// holding sl_u) and evaluates e, p = exp(e - m_v), the dot product and de
// once per edge, where a CTA per head and block row walking every column
// that any row of its warp needs would evaluate about 13 times as many. The
// column side's rows of `group` tiles are staged at once at the odd stride:
// B8 the senders' sl, B9 the receivers' sr and dnum with their m and dden. A
// row of one item writes its gradients; the items of a longer row write
// partials to a workspace slot, and the last to arrive adds them in item
// order (sum_parts): a plain sum, the same bits every run. A block row
// without tiles writes zeros. Up to F = 40 the own row and the outputs sit in
// registers (B8's own dnum in shared memory, transposed).
//
// Wider heads run the F-chunked kernels (whole staged rows of every operand
// would outgrow an H100's 227 KB above F = 144), whose shared memory does
// not grow with F: CW = 32 columns of the staged rows and EB floats a thread per own edge
// (its logit and dot product carried from chunk to chunk, so the terms still
// add in the order f = 0 .. F-1), each head's walk in two passes over the
// chunks: the logits and weights, then the outputs. B7 above F = 208 does the
// same, its second pass running the online softmax once per slab.
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
// unrolled at the compiled width FP); B7's wider heads, on its width-64
// kernel, read it from shared memory in chunks of CH columns; B8's and B9's
// run the chunked kernels.
constexpr int CH = 16;
constexpr int MAX_REG_F = 40;
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
// f = 0 .. F-1 (added onto e: the chunked kernels carry it from chunk to
// chunk): with the own row in registers (FP columns) or in shared memory
// (w columns, a multiple of CH).
template <int FP>
__device__ __forceinline__ float logit_reg(const float* a_sh, const float own[FP],
                                           const float* xj, float slope, float e = 0.f) {
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
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_item_kernel(const void* __restrict__ tiles, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ items, Geo geo,
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
  const long long row0 = first_node<ANY>(geo, it.row), v = own_node<ANY>(geo, it.row, n);
  const Partials parts(ws, n_slots, h, hf);

  load_item_tiles<ANY>(geo, it, tiles, bf16, block_cols, mask_sh, cols_sh);
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
        stage_tiles(sl_sh, S, W, sl, cols_sh + g0, gn, n, hf, head * f, f, col_unit<ANY>);
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
    merge_parts<ANY>(geo, it, parts, num_out, den_out, m_out, n, h, hf);
}


// ------------------------------------------------------------------------
// B8 and B9 on work items, and the F-chunked kernels (B8 and B9 above
// F = 40, B7 above F = 208).
// ------------------------------------------------------------------------

// One column's update of B8 (dsr and dapart) and of B9 (dsl), for an edge
// of weight p and gradient de; pre = own + x.
__device__ __forceinline__ void recv_col(float& gsr, float& gap, float de, float a, float own,
                                         float x, float slope) {
  const float pre = own + x;
  gsr = fmaf(de, a * dleaky(pre, slope), gsr);
  gap = fmaf(de, leaky(pre, slope), gap);
}
__device__ __forceinline__ void send_col(float& g, float p, float de, float a, float own, float x,
                                         float d, float slope) {
  g = fmaf(p, d, g);
  g = fmaf(de, a * dleaky(own + x, slope), g);
}

// B8 for heads up to MAX_REG_F wide. blockIdx.x is a work item (B7's, on
// the same tiles); per head the own sr row and the outputs dsr and dapart sit
// in registers, the own dnum row in shared memory transposed ([FP][TM]: the
// warp's lanes read 32 banks), and the senders' sl rows of `group` tiles are
// staged at once at the odd stride.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_recv_item_kernel(const void* __restrict__ tiles, int bf16,
                           const int* __restrict__ block_cols, const int* __restrict__ items,
                           Geo geo, const float* __restrict__ sl, const float* __restrict__ sr,
                           const float* __restrict__ a, const float* __restrict__ m_in,
                           const float* __restrict__ dnum, const float* __restrict__ dden,
                           float* __restrict__ dsr_out, float* __restrict__ dapart_out,
                           float* __restrict__ ws, int* __restrict__ counters, int n, int h,
                           int f, int max_tiles, int group, float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                   // [C][TM]: own words
  float* a_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [FP]
  float* dn_sh = a_sh + FP;                                          // [FP][TM]
  float* sl_sh = dn_sh + FP * TM;                                    // [group][TK][S]
  int* cols_sh = reinterpret_cast<int*>(sl_sh + group * TK * S);     // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, it.row, n);
  float* const dst_sr = grad_row(it, ws, 2 * hf, 0, dsr_out, hf, v, n);
  float* const dst_ap = grad_row(it, ws, 2 * hf, hf, dapart_out, hf, v, n);
  load_item_tiles<ANY>(geo, it, tiles, bf16, block_cols, mask_sh, cols_sh);

  for (int head = 0; head < h; ++head) {
    float srv[FP], gsr[FP], gap[FP];
    load_row<FP>(srv, sr, v, n, hf, head, f);
#pragma unroll
    for (int k = 0; k < FP; ++k) {
      dn_sh[k * TM + i] =
          (v < n && k < f) ? dnum[v * hf + static_cast<long long>(head) * f + k] : 0.f;
      gsr[k] = gap[k] = 0.f;
    }
    const float mv = node(m_in, v, n, h, head), dd = node(dden, v, n, h, head);
    for (int g0 = 0; g0 < nt; g0 += group) {
      const int gn = min(group, nt - g0);
      __syncthreads();  // the previous senders and a are no longer read
      if (g0 == 0) stage_a(a_sh, a, head, f, FP);
      stage_tiles(sl_sh, S, FP, sl, cols_sh + g0, gn, n, hf, head * f, f, col_unit<ANY>);
      __syncthreads();
      for (int t = g0; t < g0 + gn; ++t) {
        const float* st = sl_sh + (t - g0) * TK * S;
        for_own_edges(mask_sh[t * TM + i], [&](int j) {
          const float* xj = st + j * S;
          const float e = logit_reg<FP>(a_sh, srv, xj, slope);
          float gdot = 0.f;
#pragma unroll
          for (int q = 0; q < FP / 4; ++q) {
            const float4 s = lds4(xj + 4 * q);
            gdot = fmaf(dn_sh[(4 * q + 0) * TM + i], s.x, gdot);
            gdot = fmaf(dn_sh[(4 * q + 1) * TM + i], s.y, gdot);
            gdot = fmaf(dn_sh[(4 * q + 2) * TM + i], s.z, gdot);
            gdot = fmaf(dn_sh[(4 * q + 3) * TM + i], s.w, gdot);
          }
          const float de = expf(e - mv) * (gdot + dd);
          reread_shared();
#pragma unroll
          for (int q = 0; q < FP / 4; ++q) {
            const float4 x = lds4(xj + 4 * q), av = lds4(a_sh + 4 * q);
            const int k = 4 * q;
            recv_col(gsr[k], gap[k], de, av.x, srv[k], x.x, slope);
            recv_col(gsr[k + 1], gap[k + 1], de, av.y, srv[k + 1], x.y, slope);
            recv_col(gsr[k + 2], gap[k + 2], de, av.z, srv[k + 2], x.z, slope);
            recv_col(gsr[k + 3], gap[k + 3], de, av.w, srv[k + 3], x.w, slope);
          }
        });
      }
    }
    put_cols<FP>(dst_sr, head * f, f, gsr);
    put_cols<FP>(dst_ap, head * f, f, gap);
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    sum_parts<ANY>(geo, it, ws, 2 * hf, dsr_out, dapart_out, n, hf);
}

// B9 for heads up to MAX_REG_F wide, over the transpose tiles (the item's
// block row holds senders u): per head the own sl row and dsl in registers;
// the receivers' sr and dnum rows, m and dden of `group` tiles staged at once.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_send_item_kernel(const void* __restrict__ tiles_t, int bf16,
                           const int* __restrict__ block_cols, const int* __restrict__ items,
                           Geo geo, const float* __restrict__ sl, const float* __restrict__ sr,
                           const float* __restrict__ a, const float* __restrict__ m_in,
                           const float* __restrict__ dnum, const float* __restrict__ dden,
                           float* __restrict__ dsl_out, float* __restrict__ ws,
                           int* __restrict__ counters, int n, int h, int f, int max_tiles,
                           int group, float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                   // [C][TM]: own words
  float* a_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [FP]
  float* sr_sh = a_sh + FP;                                          // [group][TK][S]
  float* dn_sh = sr_sh + group * TK * S;                             // [group][TK][S]
  float* m_sh = dn_sh + group * TK * S;                              // [group][TK]
  float* dd_sh = m_sh + group * TK;                                  // [group][TK]
  int* cols_sh = reinterpret_cast<int*>(dd_sh + group * TK);         // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long u = own_node<ANY>(geo, it.row, n);  // sender
  float* const dst_sl = grad_row(it, ws, hf, 0, dsl_out, hf, u, n);
  load_item_tiles<ANY>(geo, it, tiles_t, bf16, block_cols, mask_sh, cols_sh);

  for (int head = 0; head < h; ++head) {
    float slu[FP], g[FP];
    load_row<FP>(slu, sl, u, n, hf, head, f);
#pragma unroll
    for (int k = 0; k < FP; ++k) g[k] = 0.f;
    for (int g0 = 0; g0 < nt; g0 += group) {
      const int gn = min(group, nt - g0);
      __syncthreads();  // the previous receivers and a are no longer read
      if (g0 == 0) stage_a(a_sh, a, head, f, FP);
      stage_tiles(sr_sh, S, FP, sr, cols_sh + g0, gn, n, hf, head * f, f, col_unit<ANY>);
      stage_tiles(dn_sh, S, FP, dnum, cols_sh + g0, gn, n, hf, head * f, f, col_unit<ANY>);
      stage_tiles(m_sh, 1, 1, m_in, cols_sh + g0, gn, n, h, head, 1, col_unit<ANY>);
      stage_tiles(dd_sh, 1, 1, dden, cols_sh + g0, gn, n, h, head, 1, col_unit<ANY>);
      __syncthreads();
      for (int t = g0; t < g0 + gn; ++t) {
        const int tb = (t - g0) * TK;
        for_own_edges(mask_sh[t * TM + i], [&](int j) {
          const float *xj = sr_sh + (tb + j) * S, *dj = dn_sh + (tb + j) * S;
          const float e = logit_reg<FP>(a_sh, slu, xj, slope);
          float gdot = 0.f;
#pragma unroll
          for (int q = 0; q < FP / 4; ++q)
            gdot = dot4(gdot, make_float4(slu[4 * q], slu[4 * q + 1], slu[4 * q + 2], slu[4 * q + 3]),
                        lds4(dj + 4 * q));
          const float p = expf(e - m_sh[tb + j]);
          const float de = p * (gdot + dd_sh[tb + j]);
          reread_shared();
#pragma unroll
          for (int q = 0; q < FP / 4; ++q) {
            const float4 x = lds4(xj + 4 * q), d = lds4(dj + 4 * q), av = lds4(a_sh + 4 * q);
            const int k = 4 * q;
            send_col(g[k], p, de, av.x, slu[k], x.x, d.x, slope);
            send_col(g[k + 1], p, de, av.y, slu[k + 1], x.y, d.y, slope);
            send_col(g[k + 2], p, de, av.z, slu[k + 2], x.z, d.z, slope);
            send_col(g[k + 3], p, de, av.w, slu[k + 3], x.w, d.w, slope);
          }
        });
      }
    }
    put_cols<FP>(dst_sl, head * f, f, g);
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    sum_parts<ANY>(geo, it, ws, hf, dsl_out, nullptr, n, hf);
}

// The F-chunked kernels: B8 and B9 above MAX_REG_F, B7 above the staged
// kernel's reach. Shared memory holds CW columns of the staged rows and EB
// values a thread per own edge, whatever F. A thread's own edges of the item
// are numbered in walk order (tiles in order, each tile's bits in order) and
// taken EB at a time (a batch; rarely more than one). Per head and batch,
// pass 1 walks the edges once per chunk of CW columns, carrying each edge's
// logit (and B8's and B9's dot product) in shared memory from chunk to chunk,
// so the terms are added in the order f = 0 .. F-1 as in the other kernels;
// after the last chunk it turns them into the edge's weights. Pass 2 walks
// them once per chunk again and accumulates that chunk's outputs in
// registers. A later batch reads back the outputs the earlier one wrote.
constexpr int CW = 32;  // columns of a chunk
constexpr int EB = 32;  // own edges of a batch, a thread
constexpr int CS = slab_stride(CW);

__device__ __forceinline__ int block_max(int x) {
  __shared__ int warp_max[THREADS / 32];
  x = __reduce_max_sync(FULL, x);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = x;
  __syncthreads();
  int r = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) r = max(r, warp_max[w]);
  return r;
}

// Batches of EB own edges that the CTA walks: at least one, so that a row
// without edges writes its zeros (or m = NEG).
__device__ __forceinline__ int own_batches(const uint4* mask_sh, int nt) {
  int count = 0;
  for (int t = 0; t < nt; ++t) {
    const uint4 w = mask_sh[t * TM + threadIdx.x];
    count += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
  }
  return max(1, (block_max(count) + EB - 1) / EB);
}

// body(t, j, slot) for this thread's own edges in tiles [t0, t1) whose
// number, counted on from k, lies in lo .. lo + EB - 1 (slot = number - lo).
template <typename Body>
__device__ __forceinline__ void for_batch_edges(const uint4* mask_sh, int t0, int t1, int& k,
                                                int lo, Body body) {
  for (int t = t0; t < t1; ++t) {
    const uint4 w = mask_sh[t * TM + threadIdx.x];
    const int c = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    if (k + c > lo && k < lo + EB) {
      int kk = k;
      for_own_edges(w, [&](int j) {
        if (kk >= lo && kk < lo + EB) body(t, j, kk - lo);
        ++kk;
      });
    }
    k += c;
  }
}

// a[head, c0 .. c0 + CW) into a_sh, zero past f.
__device__ __forceinline__ void stage_a_chunk(float* a_sh, const float* a, int head, int f,
                                              int c0) {
  for (int k = threadIdx.x; k < CW; k += THREADS)
    a_sh[k] = c0 + k < f ? a[static_cast<long long>(head) * f + c0 + k] : 0.f;
}

// sum_f x[f] y[f] over W columns from d on, f in order; y in shared memory.
template <int W>
__device__ __forceinline__ float dot_reg(const float x[W], const float* y, float d) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    d = dot4(d, make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]), lds4(y + 4 * q));
  return d;
}

// Stage chunk c0 of a and of the column side's rows under tiles
// g0 .. g0 + gn (x_sh: x's rows; with y, y_sh: y's rows too; with m_in, m and
// dden of those columns into m_sh and dd_sh), between the barriers that keep
// the previous chunk's readers and this chunk's apart; `unit` is col_unit.
__device__ __forceinline__ void stage_chunk(float* a_sh, const float* a, float* x_sh,
                                            const float* x, float* y_sh, const float* y,
                                            float* m_sh, const float* m_in, float* dd_sh,
                                            const float* dden, const int* cols_sh, int g0,
                                            int gn, int n, int h, int f, int head, int c0,
                                            int unit) {
  const int hf = h * f, fw = min(CW, f - c0);
  __syncthreads();  // the previous chunk is no longer read
  if (g0 == 0) stage_a_chunk(a_sh, a, head, f, c0);
  stage_tiles(x_sh, CS, CW, x, cols_sh + g0, gn, n, hf, head * f + c0, fw, unit);
  if (y != nullptr)
    stage_tiles(y_sh, CS, CW, y, cols_sh + g0, gn, n, hf, head * f + c0, fw, unit);
  if (m_in != nullptr) {
    stage_tiles(m_sh, 1, 1, m_in, cols_sh + g0, gn, n, h, head, 1, unit);
    stage_tiles(dd_sh, 1, 1, dden, cols_sh + g0, gn, n, h, head, 1, unit);
  }
  __syncthreads();
}

// B8, any F. Per edge: pass 1 the logit and sl_u . dnum_v, then
// de = exp(e - m_v) (gdot + dden_v); pass 2 dsr and dapart, CW columns at a time.
template <bool ANY>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_recv_chunk_kernel(const void* __restrict__ tiles, int bf16,
                            const int* __restrict__ block_cols, const int* __restrict__ items,
                            Geo geo, const float* __restrict__ sl, const float* __restrict__ sr,
                            const float* __restrict__ a, const float* __restrict__ m_in,
                            const float* __restrict__ dnum, const float* __restrict__ dden,
                            float* __restrict__ dsr_out, float* __restrict__ dapart_out,
                            float* __restrict__ ws, int* __restrict__ counters, int n, int h,
                            int f, int max_tiles, int group, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                  // [C][TM]: own words
  float* ebuf = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [EB][TM]: e, then de
  float* gbuf = ebuf + EB * TM;                                      // [EB][TM]: gdot
  float* a_sh = gbuf + EB * TM;                                      // [CW]
  float* sl_sh = a_sh + CW;                                          // [group][TK][CS]
  int* cols_sh = reinterpret_cast<int*>(sl_sh + group * TK * CS);    // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, it.row, n);
  float* const dst_sr = grad_row(it, ws, 2 * hf, 0, dsr_out, hf, v, n);
  float* const dst_ap = grad_row(it, ws, 2 * hf, hf, dapart_out, hf, v, n);
  load_item_tiles<ANY>(geo, it, tiles, bf16, block_cols, mask_sh, cols_sh);
  __syncthreads();
  const int batches = own_batches(mask_sh, nt);

  for (int head = 0; head < h; ++head) {
    const float mv = node(m_in, v, n, h, head), dd = node(dden, v, n, h, head);
    for (int b = 0; b < batches; ++b) {
      const int lo = b * EB;
      for (int c0 = 0; c0 < f; c0 += CW) {  // pass 1
        const int fw = min(CW, f - c0);
        const bool last = c0 + CW >= f;
        float osr[CW], odn[CW];
        load_cols<CW>(osr, sr, v, n, hf, head * f + c0, fw);
        load_cols<CW>(odn, dnum, v, n, hf, head * f + c0, fw);
        int k = 0;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          stage_chunk(a_sh, a, sl_sh, sl, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      cols_sh, g0, gn, n, h, f, head, c0, col_unit<ANY>);
          for_batch_edges(mask_sh, g0, g0 + gn, k, lo, [&](int t, int j, int s) {
            const float* xj = sl_sh + ((t - g0) * TK + j) * CS;
            float *eb = ebuf + s * TM + i, *gb = gbuf + s * TM + i;
            const float e = logit_reg<CW>(a_sh, osr, xj, slope, c0 ? *eb : 0.f);
            const float gdot = dot_reg<CW>(odn, xj, c0 ? *gb : 0.f);
            if (last) {
              *eb = expf(e - mv) * (gdot + dd);
            } else {
              *eb = e;
              *gb = gdot;
            }
          });
        }
      }
      for (int c0 = 0; c0 < f; c0 += CW) {  // pass 2
        const int fw = min(CW, f - c0);
        float osr[CW], gsr[CW], gap[CW];
        load_cols<CW>(osr, sr, v, n, hf, head * f + c0, fw);
        get_cols<CW>(gsr, b ? dst_sr : nullptr, head * f + c0, fw);
        get_cols<CW>(gap, b ? dst_ap : nullptr, head * f + c0, fw);
        int k = 0;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          stage_chunk(a_sh, a, sl_sh, sl, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      cols_sh, g0, gn, n, h, f, head, c0, col_unit<ANY>);
          for_batch_edges(mask_sh, g0, g0 + gn, k, lo, [&](int t, int j, int s) {
            const float* xj = sl_sh + ((t - g0) * TK + j) * CS;
            const float de = ebuf[s * TM + i];
#pragma unroll
            for (int q = 0; q < CW / 4; ++q) {
              const float4 x = lds4(xj + 4 * q), av = lds4(a_sh + 4 * q);
              const int k = 4 * q;
              recv_col(gsr[k], gap[k], de, av.x, osr[k], x.x, slope);
              recv_col(gsr[k + 1], gap[k + 1], de, av.y, osr[k + 1], x.y, slope);
              recv_col(gsr[k + 2], gap[k + 2], de, av.z, osr[k + 2], x.z, slope);
              recv_col(gsr[k + 3], gap[k + 3], de, av.w, osr[k + 3], x.w, slope);
            }
          });
        }
        put_cols<CW>(dst_sr, head * f + c0, fw, gsr);
        put_cols<CW>(dst_ap, head * f + c0, fw, gap);
      }
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    sum_parts<ANY>(geo, it, ws, 2 * hf, dsr_out, dapart_out, n, hf);
}

// B9, any F. Per edge: pass 1 the logit and sl_u . dnum_v, then
// p = exp(e - m_v) and de = p (gdot + dden_v); pass 2 dsl, CW columns at a time.
template <bool ANY>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_send_chunk_kernel(const void* __restrict__ tiles_t, int bf16,
                            const int* __restrict__ block_cols, const int* __restrict__ items,
                            Geo geo, const float* __restrict__ sl, const float* __restrict__ sr,
                            const float* __restrict__ a, const float* __restrict__ m_in,
                            const float* __restrict__ dnum, const float* __restrict__ dden,
                            float* __restrict__ dsl_out, float* __restrict__ ws,
                            int* __restrict__ counters, int n, int h, int f, int max_tiles,
                            int group, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                  // [C][TM]: own words
  float* ebuf = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [EB][TM]: e, then p
  float* gbuf = ebuf + EB * TM;                                      // [EB][TM]: gdot, then de
  float* a_sh = gbuf + EB * TM;                                      // [CW]
  float* sr_sh = a_sh + CW;                                          // [group][TK][CS]
  float* dn_sh = sr_sh + group * TK * CS;                            // [group][TK][CS]
  float* m_sh = dn_sh + group * TK * CS;                             // [group][TK]
  float* dd_sh = m_sh + group * TK;                                  // [group][TK]
  int* cols_sh = reinterpret_cast<int*>(dd_sh + group * TK);         // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long u = own_node<ANY>(geo, it.row, n);  // sender
  float* const dst_sl = grad_row(it, ws, hf, 0, dsl_out, hf, u, n);
  load_item_tiles<ANY>(geo, it, tiles_t, bf16, block_cols, mask_sh, cols_sh);
  __syncthreads();
  const int batches = own_batches(mask_sh, nt);

  for (int head = 0; head < h; ++head) {
    for (int b = 0; b < batches; ++b) {
      const int lo = b * EB;
      for (int c0 = 0; c0 < f; c0 += CW) {  // pass 1
        const bool last = c0 + CW >= f;
        float osl[CW];
        load_cols<CW>(osl, sl, u, n, hf, head * f + c0, min(CW, f - c0));
        int k = 0;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          stage_chunk(a_sh, a, sr_sh, sr, dn_sh, dnum, m_sh, last ? m_in : nullptr, dd_sh, dden,
                      cols_sh, g0, gn, n, h, f, head, c0, col_unit<ANY>);
          for_batch_edges(mask_sh, g0, g0 + gn, k, lo, [&](int t, int j, int s) {
            const int at = (t - g0) * TK + j;
            float *eb = ebuf + s * TM + i, *gb = gbuf + s * TM + i;
            const float e = logit_reg<CW>(a_sh, osl, sr_sh + at * CS, slope, c0 ? *eb : 0.f);
            const float gdot = dot_reg<CW>(osl, dn_sh + at * CS, c0 ? *gb : 0.f);
            if (last) {
              const float p = expf(e - m_sh[at]);
              *eb = p;
              *gb = p * (gdot + dd_sh[at]);
            } else {
              *eb = e;
              *gb = gdot;
            }
          });
        }
      }
      for (int c0 = 0; c0 < f; c0 += CW) {  // pass 2
        const int fw = min(CW, f - c0);
        float osl[CW], g[CW];
        load_cols<CW>(osl, sl, u, n, hf, head * f + c0, fw);
        get_cols<CW>(g, b ? dst_sl : nullptr, head * f + c0, fw);
        int k = 0;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          stage_chunk(a_sh, a, sr_sh, sr, dn_sh, dnum, m_sh, nullptr, dd_sh, dden, cols_sh, g0,
                      gn, n, h, f, head, c0, col_unit<ANY>);
          for_batch_edges(mask_sh, g0, g0 + gn, k, lo, [&](int t, int j, int s) {
            const int at = (t - g0) * TK + j;
            const float p = ebuf[s * TM + i], de = gbuf[s * TM + i];
#pragma unroll
            for (int q = 0; q < CW / 4; ++q) {
              const float4 x = lds4(sr_sh + at * CS + 4 * q), d = lds4(dn_sh + at * CS + 4 * q);
              const float4 av = lds4(a_sh + 4 * q);
              const int k = 4 * q;
              send_col(g[k], p, de, av.x, osl[k], x.x, d.x, slope);
              send_col(g[k + 1], p, de, av.y, osl[k + 1], x.y, d.y, slope);
              send_col(g[k + 2], p, de, av.z, osl[k + 2], x.z, d.z, slope);
              send_col(g[k + 3], p, de, av.w, osl[k + 3], x.w, d.w, slope);
            }
          });
        }
        put_cols<CW>(dst_sl, head * f + c0, fw, g);
      }
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    sum_parts<ANY>(geo, it, ws, hf, dsl_out, nullptr, n, hf);
}

// B7 above the staged kernel's reach (its rows of all F columns would
// outgrow the card's shared memory). Pass 1 as above carries each own edge's
// logit through the chunks; pass 2 runs B7's online softmax over the logits
// once per CW-column slab of num, each slab from the batch's starting state
// (the same m and den every slab), the split rows' partials merged as B7's.
template <bool ANY>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_chunk_kernel(const void* __restrict__ tiles, int bf16,
                       const int* __restrict__ block_cols, const int* __restrict__ items, Geo geo,
                       const float* __restrict__ sl, const float* __restrict__ sr,
                       const float* __restrict__ a, float* __restrict__ num_out,
                       float* __restrict__ den_out, float* __restrict__ m_out,
                       float* __restrict__ ws, int* __restrict__ counters, int n_slots, int n,
                       int h, int f, int max_tiles, int group, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                  // [C][TM]: own words
  float* ebuf = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [EB][TM]: e
  float* a_sh = ebuf + EB * TM;                                      // [CW]
  float* sl_sh = a_sh + CW;                                          // [group][TK][CS]
  int* cols_sh = reinterpret_cast<int*>(sl_sh + group * TK * CS);    // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, it.row, n);
  const Partials parts(ws, n_slots, h, hf);
  // this thread's num row (nullptr past n), as put_softmax writes it
  float* num_row = it.slot < 0 ? (v < n ? num_out + v * hf : nullptr)
                               : parts.num + (static_cast<size_t>(it.slot) * TM + i) * hf;
  load_item_tiles<ANY>(geo, it, tiles, bf16, block_cols, mask_sh, cols_sh);
  __syncthreads();
  const int batches = own_batches(mask_sh, nt);

  for (int head = 0; head < h; ++head) {
    float m_run = NEG, den_run = 0.f;
    for (int b = 0; b < batches; ++b) {
      const int lo = b * EB;
      for (int c0 = 0; c0 < f; c0 += CW) {  // pass 1: the logits
        float osr[CW];
        load_cols<CW>(osr, sr, v, n, hf, head * f + c0, min(CW, f - c0));
        int k = 0;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          stage_chunk(a_sh, a, sl_sh, sl, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      cols_sh, g0, gn, n, h, f, head, c0, col_unit<ANY>);
          for_batch_edges(mask_sh, g0, g0 + gn, k, lo, [&](int t, int j, int s) {
            float* eb = ebuf + s * TM + i;
            *eb = logit_reg<CW>(a_sh, osr, sl_sh + ((t - g0) * TK + j) * CS, slope,
                                c0 ? *eb : 0.f);
          });
        }
      }
      float m = m_run, den = den_run;
      for (int s0 = 0; s0 < f; s0 += CW) {  // pass 2: the softmax, one slab of num at a time
        const int fw = min(CW, f - s0);
        float acc[CW];
        get_cols<CW>(acc, b ? num_row : nullptr, head * f + s0, fw);
        m = m_run;
        den = den_run;
        int k = 0;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          stage_chunk(a_sh, a, sl_sh, sl, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      cols_sh, g0, gn, n, h, f, head, s0, col_unit<ANY>);
          for_batch_edges(mask_sh, g0, g0 + gn, k, lo, [&](int t, int j, int s) {
            const float e = ebuf[s * TM + i];
            if (e > m) {
              const float corr = expf(m - e);  // from NEG: 0, with den and num still 0
              den *= corr;
#pragma unroll
              for (int kk = 0; kk < CW; ++kk) acc[kk] *= corr;
              m = e;
            }
            const float p = expf(e - m);
            den += p;
            const float* xj = sl_sh + ((t - g0) * TK + j) * CS;
#pragma unroll
            for (int q = 0; q < CW / 4; ++q) {
              const float4 x = lds4(xj + 4 * q);
              acc[4 * q + 0] = fmaf(p, x.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(p, x.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(p, x.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(p, x.w, acc[4 * q + 3]);
            }
          });
        }
        put_softmax<CW>(it, parts, num_out, den_out, m_out, v, n, h, hf, head, f, s0, fw, acc,
                        den, m);
      }
      m_run = m;
      den_run = den;
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    merge_parts<ANY>(geo, it, parts, num_out, den_out, m_out, n, h, hf);
}

// Each kernel's dynamic shared memory at per-head width f (compiled width
// fp) and C = max_tiles, and how many of an item's tiles it stages at once.
// Above F = MAX_REG_F (B8, B9) and past the staged B7's reach it depends on
// C but not on F.
constexpr int MAX_STAGED_F = 208;    // the widest F of the staged B7
size_t item_bytes(int max_tiles) {
  return static_cast<size_t>(max_tiles) * (TM * sizeof(uint4) + sizeof(int));
}
int fwd_group(int f, int max_tiles) {
  return tile_group(sizeof(float) * TK * slab_stride(staged_width(f)), max_tiles);
}
size_t fwd_smem(int f, int fp, int max_tiles) {
  const int w = staged_width(f);
  return item_bytes(max_tiles) +
         sizeof(float) * (w + (own_rows(fp) + static_cast<size_t>(fwd_group(f, max_tiles)) * TK) *
                                  slab_stride(w) +
                          fp);
}
// B8: the senders' rows of a tile; B9: the receivers' sr and dnum rows, m and dden.
size_t recv_tile_bytes(int stride) { return sizeof(float) * TK * stride; }
size_t send_tile_bytes(int stride) { return sizeof(float) * 2 * TK * (stride + 1); }
int recv_group(int stride, int max_tiles) { return tile_group(recv_tile_bytes(stride), max_tiles); }
int send_group(int stride, int max_tiles) { return tile_group(send_tile_bytes(stride), max_tiles); }
size_t recv_item_smem(int fp, int max_tiles) {
  return item_bytes(max_tiles) + sizeof(float) * (fp + fp * TM) +
         recv_group(slab_stride(fp), max_tiles) * recv_tile_bytes(slab_stride(fp));
}
size_t send_item_smem(int fp, int max_tiles) {
  return item_bytes(max_tiles) + sizeof(float) * fp +
         send_group(slab_stride(fp), max_tiles) * send_tile_bytes(slab_stride(fp));
}
// The chunked kernels: the masks, `bufs` edge buffers [EB][TM] and a's chunk.
size_t chunk_base(int bufs, int max_tiles) {
  return item_bytes(max_tiles) + sizeof(float) * (bufs * EB * TM + CW);
}
size_t recv_chunk_smem(int max_tiles) {
  return chunk_base(2, max_tiles) + recv_group(CS, max_tiles) * recv_tile_bytes(CS);
}
size_t send_chunk_smem(int max_tiles) {
  return chunk_base(2, max_tiles) + send_group(CS, max_tiles) * send_tile_bytes(CS);
}
size_t fwd_chunk_smem(int max_tiles) {
  return chunk_base(1, max_tiles) + recv_group(CS, max_tiles) * recv_tile_bytes(CS);
}

// The narrow widths' pick.
template <typename Kernel>
Kernel pick_narrow(int f, Kernel k4, Kernel k8, Kernel k16, Kernel k32, Kernel k40) {
  return f <= 4 ? k4 : f <= 8 ? k8 : f <= 16 ? k16 : f <= 32 ? k32 : k40;
}

// B7, on B3's schedule and workspace (gat_tile_attn.cu: gat_tile_fwd): the
// staged kernel while its rows fit, else (or with `chunked`) the chunked one.
int v2_fwd(const void* tiles, const void* block_cols, const void* items, const void* sl,
           const void* sr, const void* a, void* num, void* den, void* m, void* ws,
           void* counters, int n_items, int n_slots, int n, int h, int f, int max_tiles,
           int tile_bf16, const Geo& geo, float slope, void* stream, bool chunked) {
  if (f < 1 || max_tiles < 1 || !geo_ok(geo)) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel, size_t smem, int group) {
    return launch(kernel, dim3(n_items), smem, stream, tiles, tile_bf16,
                  static_cast<const int*>(block_cols), static_cast<const int*>(items), geo,
                  static_cast<const float*>(sl), static_cast<const float*>(sr),
                  static_cast<const float*>(a), static_cast<float*>(num), static_cast<float*>(den),
                  static_cast<float*>(m), static_cast<float*>(ws), static_cast<int*>(counters),
                  n_slots, n, h, f, max_tiles, group, slope);
  };
  const size_t staged = fwd_smem(f, width_of(f), max_tiles);
  return by_geometry(geo, [&](auto any) {
    constexpr bool A = decltype(any)::value;
    if (chunked || f > MAX_STAGED_F || staged > MAX_SMEM)
      return go(gatv2_fwd_chunk_kernel<A>, fwd_chunk_smem(max_tiles), recv_group(CS, max_tiles));
    return go(pick_width(f, GAT_TILE_WIDTHS(gatv2_fwd_item_kernel, A)), staged,
              fwd_group(f, max_tiles));
  });
}

}  // namespace

extern "C" {

// The rows of one CTA's panel, the multiple that tile sides must be, and the
// ints of one work item of B7, B8 and B9.
int gatv2_tile_attn_config(int* panel, int* side_multiple, int* item_ints) {
  *panel = TM;
  *side_multiple = 32;
  *item_ints = ITEM_INTS;
  return 0;
}

// Every entry takes the tile geometry as gat_tile_attn.cu's do: side S,
// panels P and the panel tiles' source tiles `src`; block_cols and items are
// the panel tiles' (the tiles' own when P = 1).

// B7: the staged kernel while its rows fit, else the chunked one.
// Returns the CUDA error of the launch (0 on success).
int gatv2_tile_fwd(const void* tiles, const void* block_cols, const void* items, const void* sl,
                   const void* sr, const void* a, void* num, void* den, void* m, void* ws,
                   void* counters, int n_items, int n_slots, int n, int h, int f, int max_tiles,
                   int tile_bf16, int side, int panels, const void* src, float slope,
                   void* stream) {
  return v2_fwd(tiles, block_cols, items, sl, sr, a, num, den, m, ws, counters, n_items, n_slots,
                n, h, f, max_tiles, tile_bf16, Geo{side, panels, static_cast<const int*>(src)},
                slope, stream, false);
}

// B7 on its chunked kernel at any F, to time and test it against the staged one.
int gatv2_tile_fwd_chunked(const void* tiles, const void* block_cols, const void* items,
                           const void* sl, const void* sr, const void* a, void* num, void* den,
                           void* m, void* ws, void* counters, int n_items, int n_slots, int n,
                           int h, int f, int max_tiles, int tile_bf16, int side, int panels,
                           const void* src, float slope, void* stream) {
  return v2_fwd(tiles, block_cols, items, sl, sr, a, num, den, m, ws, counters, n_items, n_slots,
                n, h, f, max_tiles, tile_bf16, Geo{side, panels, static_cast<const int*>(src)},
                slope, stream, true);
}

// B8 over the forward tiles, on B7's work items (the same schedule and
// counters: the wrapper launches the two one after the other on one stream);
// the split rows' partials in ws [n_slots][TM][2 h f] (dsr, then dapart).
int gatv2_tile_bwd_recv(const void* tiles, const void* block_cols, const void* items,
                        const void* sl, const void* sr, const void* a, const void* m,
                        const void* dnum, const void* dden, void* dsr, void* dapart, void* ws,
                        void* counters, int n_items, int n_slots, int n, int h, int f,
                        int max_tiles, int tile_bf16, int side, int panels, const void* src,
                        float slope, void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || max_tiles < 1 || n_slots < 0 || !geo_ok(geo))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel, size_t smem, int group) {
    return launch(kernel, dim3(n_items), smem, stream, tiles, tile_bf16,
                  static_cast<const int*>(block_cols), static_cast<const int*>(items), geo,
                  static_cast<const float*>(sl), static_cast<const float*>(sr),
                  static_cast<const float*>(a), static_cast<const float*>(m),
                  static_cast<const float*>(dnum), static_cast<const float*>(dden),
                  static_cast<float*>(dsr), static_cast<float*>(dapart), static_cast<float*>(ws),
                  static_cast<int*>(counters), n, h, f, max_tiles, group, slope);
  };
  return by_geometry(geo, [&](auto any) {
    constexpr bool A = decltype(any)::value;
    if (f > MAX_REG_F)
      return go(gatv2_bwd_recv_chunk_kernel<A>, recv_chunk_smem(max_tiles),
                recv_group(CS, max_tiles));
    const int fp = width_of(f);
    return go(pick_narrow(f, gatv2_bwd_recv_item_kernel<4, A>, gatv2_bwd_recv_item_kernel<8, A>,
                          gatv2_bwd_recv_item_kernel<16, A>, gatv2_bwd_recv_item_kernel<32, A>,
                          gatv2_bwd_recv_item_kernel<40, A>),
              recv_item_smem(fp, max_tiles), recv_group(slab_stride(fp), max_tiles));
  });
}

// B9 over the transpose tiles (block rows are senders), on their own work
// items; the split rows' partials in ws [n_slots][TM][h f].
int gatv2_tile_bwd_send(const void* tiles_t, const void* block_cols, const void* items,
                        const void* sl, const void* sr, const void* a, const void* m,
                        const void* dnum, const void* dden, void* dsl, void* ws, void* counters,
                        int n_items, int n_slots, int n, int h, int f, int max_tiles,
                        int tile_bf16, int side, int panels, const void* src, float slope,
                        void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || max_tiles < 1 || n_slots < 0 || !geo_ok(geo))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel, size_t smem, int group) {
    return launch(kernel, dim3(n_items), smem, stream, tiles_t, tile_bf16,
                  static_cast<const int*>(block_cols), static_cast<const int*>(items), geo,
                  static_cast<const float*>(sl), static_cast<const float*>(sr),
                  static_cast<const float*>(a), static_cast<const float*>(m),
                  static_cast<const float*>(dnum), static_cast<const float*>(dden),
                  static_cast<float*>(dsl), static_cast<float*>(ws), static_cast<int*>(counters),
                  n, h, f, max_tiles, group, slope);
  };
  return by_geometry(geo, [&](auto any) {
    constexpr bool A = decltype(any)::value;
    if (f > MAX_REG_F)
      return go(gatv2_bwd_send_chunk_kernel<A>, send_chunk_smem(max_tiles),
                send_group(CS, max_tiles));
    const int fp = width_of(f);
    return go(pick_narrow(f, gatv2_bwd_send_item_kernel<4, A>, gatv2_bwd_send_item_kernel<8, A>,
                          gatv2_bwd_send_item_kernel<16, A>, gatv2_bwd_send_item_kernel<32, A>,
                          gatv2_bwd_send_item_kernel<40, A>),
              send_item_smem(fp, max_tiles), send_group(slab_stride(fp), max_tiles));
  });
}

}  // extern "C"
