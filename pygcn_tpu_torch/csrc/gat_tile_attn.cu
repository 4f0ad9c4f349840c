// Kernels B3, B5 and B6, and their per-tile modes B4, B5s and B6s, for Hopper
// (sm_90a): GAT attention over BCSR tiles.
//
// For a tile edge u -> v (tile[v][u] != 0; the tile's value is never
// multiplied in) and head h:  e = leaky(ldst[v,h] + lsrc[u,h]).
//
//   B3 (replaces pygcn_tpu/ops/pallas/gat_tile_attn.py:_fwd_kernel_revisit):
//      m[v,h]   = max over v's tile edges of e (NEG where v has none)
//      den[v,h] = sum_u exp(e - m),  num[v, hF:(h+1)F] = sum_u exp(e - m) s2[u, hF:(h+1)F]
//   B5 (replaces _bwd_dldst_kernel, stream=False), over the forward tiles:
//      dldst[v,h] = sum_u p (s2[u,h.] . dnum[v,h.] + dden[v,h]) leaky'(pre)
//   B6 (replaces _bwd_sender_kernel, stream=False), over the transpose tiles
//      (rows are senders u, columns receivers v):
//      ds[u, h.] = sum_v p dnum[v, h.],   dlsrc[u,h] = sum_v (the B5 term)
//   with pre = ldst[v,h] + lsrc[u,h], p = exp(leaky(pre) - m[v,h]) and
//   leaky'(pre) = pre >= 0 ? 1 : slope (the derivative jax.nn.leaky_relu has).
//
// Bound on an H100 SXM at the ogbn-arxiv hybrid (2863 f32 tiles, 3.1M tile
// edges, N = 169,343; layer 1 H = 8, F = 8): each launch must read the tiles as
// stored (0.19 GB) plus O(N (H + H F)) bytes of operands and outputs (about
// 0.1 GB), about 0.09 ms at 3.35 TB/s; its 20-40 operations per edge and head
// take under 0.01 ms at the 67 TFLOP/s f32 rate: bound by bytes.
//
// B3's design (gat_fwd_item_kernel). The TPU grid runs the tiles in order and
// carries a block row's running max, num and den in a revisited output block.
// Here the wrapper cuts each block row's tiles into work items of at most C
// consecutive tiles (the schedule of B1, cached per tile set), one CTA of 128
// threads per item for all heads, thread i owning row i of the block:
// - The CTA decodes each of its tiles' masks once, into 2 KB of shared memory
//   a tile, and reuses the words for every head and F-slab (the tiles are read
//   once, not once per head).
// - Each thread walks only its own row's edges (for_own_edges): at the
//   flagship 8.5 a tile on average and 15 for a warp's busiest lane, where
//   the columns any row of the warp needs are 103 on average,
//   and gathers the senders' operands per lane from shared memory, at padded
//   strides: every head's lsrc of the item's senders, staged once (for as
//   many heads as fit, in turn, where the card's shared memory forbids all:
//   above about 210 heads at C = 2), and per head the s2 slabs of all its tiles (or
//   as many as fit in 48 KB), staged in one batch of loads, so a head costs
//   one round trip to memory and two barriers.
// - Per head (and F-slab) it takes an online softmax one edge at a time, as
//   B7 does: a row whose running max rises rescales den and num by
//   corr = exp(m_old - e) (0, with den and num still 0, for a row at NEG),
//   so each own edge is walked once (a first walk for the max, then one
//   against it, ran 2% slower on an H100 at 8 heads of 8).
// - A row of one item (at most C tiles, or none) writes its outputs once. The
//   items of a longer row write partials (m, den, num) to a workspace, and
//   the last CTA to arrive merges them in item order by the flash merge
//   (gat_tile_common.cuh: merge_parts). The longest block row (43 tiles) is
//   22 items of 2, not one CTA's walk. The same bits every run; atomics only
//   on the arrival counters. A block row without tiles writes num = den = 0
//   and m = NEG.
//
// B5 and B6 (gat_bwd_dldst_item_kernel, gat_bwd_sender_item_kernel) run on
// the same kind of work items: B5 over the forward tiles on B3's schedule and
// arrival counters (the wrapper launches B3 and B5 one after the other on
// one stream, never together), B6 over the transpose tiles on their own. One
// CTA per item for all heads, each tile's mask decoded once; each thread
// walks its own row's edges (B5: the receiver v, holding dnum_v's slab; B6:
// the sender u, holding s2_u's slab and ds; the per-edge bodies
// receiver_walk and sender_walk, which B5s and B6s share) and evaluates p,
// the F-wide dot product and the accumulations once per edge, where a CTA
// per (head, block row) walking every column that any row of its warp needs
// evaluated about 12 times as many. The column side's
// node values of all heads (of as many as fit, in turn, where the card's
// shared memory forbids all) are staged once per item at the odd stride
// H | 1 (B5: the senders' lsrc; B6: the receivers' ldst, m and dden), and
// per head the column side's slab of `group` tiles in one batch (B5: s2;
// B6: dnum). Both sums are linear in the F-wide dot products, so a head
// wider than 64 runs the walk once per 64-column slab, adding dden's term in
// the first. A row of one item writes its gradients; the items of a longer
// row write partials (B5: [TM, H]; B6: [TM, H F + H], ds then dlsrc) to a
// workspace slot, and the last to arrive adds them in item order
// (sum_parts): the same bits every run, atomics only on the counters. A
// block row without tiles writes zeros.
//
// Per-tile ("stream") modes, kernels of their own. They replace the
// TILE_REVISIT = False path of the TPU file: B4 is _fwd_kernel_stream, B5s
// and B6s are _bwd_dldst_kernel and _bwd_sender_kernel with stream=True,
// each with the merge that JAX runs after it (segment_max/segment_sum over the
// tiles' block rows). Every tile is independent: no work items, no arrival
// counters, no workspace; only the sum order is free (not the same bits
// every run), as for B2.
// - B4 (B4a then B4b, one launch as the wrapper counts it) computes the
//   merged (num, den, m). One CTA per tile for all heads, thread i on the
//   tile's row i. B4a decodes each row's mask once (the 64 KB tile is read
//   once a launch), keeps the words in a bits buffer [T][TM] (5.9 MB at the
//   flagship), and merges each row's max over its own edges into m by a float
//   atomic max: m is the plain version's bit for bit. B4b reads the bits and
//   walks the own edges again with p = exp(e - m) against the final max (no
//   running rescale), adding den and num per (row, head, slab) into
//   zero-filled outputs (red.global.add.v4.f32; scalar on ragged widths). It
//   equals the JAX merge, which rescales each tile's partials by exp(max_t
//   - m), to rounding. A receiver without a tile edge keeps num = den = 0 and
//   m = NEG.
// - B5s computes the merged dldst: one CTA per forward tile for all heads,
//   B5's per-edge walk (receiver_walk) on each receiver's own edges, the
//   tile's senders' lsrc staged for as many heads as fit, and each row's sum
//   added into a zero-filled output, one reduction per (row, head, tile).
// - B6s computes the merged (ds, dlsrc): one CTA per transpose tile for all
//   heads, B6's per-edge walk (sender_walk) on each sender's own edges, the
//   receivers' node values staged for as many heads as fit, and each row's
//   ds slab and dlsrc added into zero-filled outputs.
// Every stream kernel stages its node arrays in head groups (staged_heads),
// so it takes any number of heads. Bound of B4, B5s and B6s: B3's, B5's and
// B6's, the same functions of the same inputs (the tiles read once, the
// operand rows under them and the [N, .] outputs once), 0.09, 0.09 and 0.10
// ms at the flagship's 8x8. B4's bits buffer (11.7 MB written and read at
// the flagship) and the reductions (about 3 per row, head and tile at 8x8;
// 33 at 8x128 for B4's and B6s's F-wide outputs) are the design's own
// traffic, the price of independent tiles.
//
// Precision: expf (not __expf) and f32 FMA, no TF32, so the kernels match their
// plain PyTorch versions to rounding. Ragged shapes are masked in the kernel:
// rows of operands past n read as zero and output rows past n are not
// written, so nothing is padded by a copy. Any per-head width F: F <= 64 is
// padded in registers to the next compiled width FP, wider F runs over
// 64-column slabs. Plain C interface, loaded with ctypes.

#include "gat_tile_common.cuh"

namespace {

using namespace gat_tile;

// B3. blockIdx.x is a work item; `max_tiles` (C) sizes the shared memory and
// `group` tiles' s2 slabs are staged at once. The senders' lsrc of `hc` heads
// at a time (all of them unless the card's shared memory forbids it) are
// staged once per item.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_fwd_item_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                    const int* __restrict__ items, Geo geo, const float* __restrict__ lsrc,
                    const float* __restrict__ ldst, const float* __restrict__ s2,
                    float* __restrict__ num_out, float* __restrict__ den_out,
                    float* __restrict__ m_out, float* __restrict__ ws,
                    int* __restrict__ counters, int n_slots, int n, int h, int f,
                    int max_tiles, int group, int hc, float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                         // [C][TM]: own words
  float* s_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);         // [group][TK][S]
  float* ls_sh = s_sh + group * TK * S;                                     // [C][TK][hc | 1]
  int* cols_sh = reinterpret_cast<int*>(ls_sh + max_tiles * TK * (hc | 1));  // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, it.row, n);
  const Partials parts(ws, n_slots, h, hf);
  load_item_tiles<ANY>(geo, it, tiles, bf16, block_cols, mask_sh, cols_sh);

  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering the logits of random senders hit distinct banks
    __syncthreads();  // cols_sh; the previous heads' logits are no longer read
    stage_tiles(ls_sh, HS, hn, lsrc, cols_sh, nt, n, h, h0, hn, col_unit<ANY>);
    for (int head = h0; head < h0 + hn; ++head) {
      const float ld = node(ldst, v, n, h, head);
      for (int s0 = 0; s0 < f; s0 += FP) {
        const int fw = min(FP, f - s0);
        float m = NEG, den = 0.f, acc[FP];
#pragma unroll
        for (int k = 0; k < FP; ++k) acc[k] = 0.f;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          __syncthreads();  // the logits are staged; the previous slabs are no longer read
          stage_tiles(s_sh, S, FP, s2, cols_sh + g0, gn, n, hf, head * f + s0, fw, col_unit<ANY>);
          __syncthreads();
          for (int t = g0; t < g0 + gn; ++t) {
            const float* ls = ls_sh + t * TK * HS + (head - h0);
            const float* st = s_sh + (t - g0) * TK * S;
            for_own_edges(mask_sh[t * TM + i], [&](int j) {
              const float e = leaky(ld + ls[j * HS], slope);
              if (e > m) {
                const float corr = expf(m - e);  // from NEG: 0, with den and num still 0
                den *= corr;
#pragma unroll
                for (int k = 0; k < FP; ++k) acc[k] *= corr;
                m = e;
              }
              const float p = expf(e - m);
              den += p;
              const float4* sj = reinterpret_cast<const float4*>(st + j * S);
#pragma unroll
              for (int q = 0; q < FP / 4; ++q) {
                const float4 x = sj[q];
                acc[4 * q + 0] = fmaf(p, x.x, acc[4 * q + 0]);
                acc[4 * q + 1] = fmaf(p, x.y, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(p, x.z, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(p, x.w, acc[4 * q + 3]);
              }
            });
          }
        }
        put_softmax<FP>(it, parts, num_out, den_out, m_out, v, n, h, hf, head, f, s0, fw, acc,
                        den, m);
      }
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    merge_parts<ANY>(geo, it, parts, num_out, den_out, m_out, n, h, hf);
}

// B4a, the max: one CTA per tile for all heads, thread i on the tile's row i
// (receiver v). Decodes the row's mask once and keeps its words in
// bits [T][TM] for B4b; stages the 128 senders' lsrc of `hc` heads at a time
// (all unless the card's shared memory forbids it) at the odd stride hc | 1;
// per head takes the max of e over its own edges and merges it into m
// (prefilled with NEG) by a float atomic max. A row without an edge in the
// tile (or past n) does no atomic, but takes every barrier.
template <bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_fwd_stream_max_kernel(const void* __restrict__ tiles, int bf16,
                          const int* __restrict__ block_cols, const int* __restrict__ block_rows,
                          Geo geo, const float* __restrict__ lsrc, const float* __restrict__ ldst,
                          float* __restrict__ m_out, uint4* __restrict__ bits, int n, int h,
                          int hc, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ls_sh = reinterpret_cast<float*>(smem);  // [TK][hc | 1]
  const int t = blockIdx.x, i = threadIdx.x;
  const long long v = own_node<ANY>(geo, block_rows[t], n);
  const long long col0 = first_node<ANY>(geo, block_cols[t]);
  const uint4 own = panel_mask<ANY>(geo, tiles, bf16, t, block_rows[t], block_cols[t]);
  bits[static_cast<size_t>(t) * TM + i] = own;
  const bool live = v < n && (own.x | own.y | own.z | own.w) != 0;
  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering the logits of random senders hit distinct banks
    __syncthreads();  // the previous heads' logits are no longer read
    stage_rows(ls_sh, HS, hn, lsrc, col0, n, h, h0, hn);
    __syncthreads();
    if (!live) continue;
    for (int head = h0; head < h0 + hn; ++head) {
      const float ld = ldst[v * h + head];
      const float* ls = ls_sh + (head - h0);
      float m = NEG;
      for_own_edges(own, [&](int j) { m = fmaxf(m, leaky(ld + ls[j * HS], slope)); });
      atomic_max_float(m_out + v * h + head, m);
    }
  }
}

// B4b, the sums: one CTA per tile for all heads, thread i on row i with its
// mask words from B4a's bits. Stages lsrc in head groups as B4a does and per
// head the tile's s2 slab of FP columns (64-column slabs above F = 64); walks
// its own edges with p = exp(e - m_v) against the final max, and adds den and
// the num slab, once per (row, head, slab) that has an edge, into the
// zero-filled num and den by f32 reductions.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_fwd_stream_sum_kernel(const int* __restrict__ block_cols, const int* __restrict__ block_rows,
                          Geo geo, const uint4* __restrict__ bits, const float* __restrict__ lsrc,
                          const float* __restrict__ ldst, const float* __restrict__ s2,
                          const float* __restrict__ m_in, float* __restrict__ num_out,
                          float* __restrict__ den_out, int n, int h, int f, int hc,
                          float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sh = reinterpret_cast<float*>(smem);  // [TK][S]
  float* ls_sh = s_sh + TK * S;                  // [TK][hc | 1]
  const int t = blockIdx.x, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, block_rows[t], n);
  const long long col0 = first_node<ANY>(geo, block_cols[t]);
  const uint4 own = bits[static_cast<size_t>(t) * TM + i];
  const bool live = v < n && (own.x | own.y | own.z | own.w) != 0;
  const bool quads = f % 4 == 0;
  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering the logits of random senders hit distinct banks
    __syncthreads();  // the previous heads' logits are no longer read
    stage_rows(ls_sh, HS, hn, lsrc, col0, n, h, h0, hn);
    for (int head = h0; head < h0 + hn; ++head) {
      const float ld = live ? ldst[v * h + head] : 0.f;
      const float mv = live ? m_in[v * h + head] : 0.f;
      const float* ls = ls_sh + (head - h0);
      for (int s0 = 0; s0 < f; s0 += FP) {
        const int fw = min(FP, f - s0);
        __syncthreads();  // the logits are staged; the previous slab is no longer read
        stage_rows(s_sh, S, FP, s2, col0, n, hf, head * f + s0, fw);
        __syncthreads();
        if (!live) continue;
        float den = 0.f, acc[FP];
#pragma unroll
        for (int k = 0; k < FP; ++k) acc[k] = 0.f;
        for_own_edges(own, [&](int j) {
          const float p = expf(leaky(ld + ls[j * HS], slope) - mv);
          den += p;
          const float4* sj = reinterpret_cast<const float4*>(s_sh + j * S);
#pragma unroll
          for (int q = 0; q < FP / 4; ++q) {
            const float4 x = sj[q];
            acc[4 * q + 0] = fmaf(p, x.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(p, x.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(p, x.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(p, x.w, acc[4 * q + 3]);
          }
        });
        add_cols<FP>(num_out + v * hf + static_cast<long long>(head) * f + s0, fw, acc, quads);
        if (s0 == 0) atomicAdd(den_out + v * h + head, den);
      }
    }
  }
}

// B5. blockIdx.x is a work item of B3's schedule over the same tiles; thread
// i owns receiver v. The senders' lsrc of `hc` heads at a time (all of them
// unless the card's shared memory forbids it) are staged once per item, each
// head's s2 slab of `group` tiles in one batch; dnum_v's slab sits in
// registers.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_bwd_dldst_item_kernel(const void* __restrict__ tiles, int bf16,
                          const int* __restrict__ block_cols, const int* __restrict__ items,
                          Geo geo, const float* __restrict__ lsrc, const float* __restrict__ ldst,
                          const float* __restrict__ s2, const float* __restrict__ m_in,
                          const float* __restrict__ dnum, const float* __restrict__ dden,
                          float* __restrict__ dldst_out, float* __restrict__ ws,
                          int* __restrict__ counters, int n, int h, int f, int max_tiles,
                          int group, int hc, float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                         // [C][TM]: own words
  float* s_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);         // [group][TK][S]
  float* ls_sh = s_sh + group * TK * S;                                     // [C][TK][hc | 1]
  int* cols_sh = reinterpret_cast<int*>(ls_sh + max_tiles * TK * (hc | 1));  // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, it.row, n);
  float* const dst = grad_row(it, ws, h, 0, dldst_out, h, v, n);
  load_item_tiles<ANY>(geo, it, tiles, bf16, block_cols, mask_sh, cols_sh);

  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering the logits of random senders hit distinct banks
    __syncthreads();  // cols_sh; the previous heads' logits are no longer read
    stage_tiles(ls_sh, HS, hn, lsrc, cols_sh, nt, n, h, h0, hn, col_unit<ANY>);
    for (int head = h0; head < h0 + hn; ++head) {
      const float ld = node(ldst, v, n, h, head), mv = node(m_in, v, n, h, head);
      float acc = 0.f;
      for (int s0 = 0; s0 < f; s0 += FP) {
        const int fw = min(FP, f - s0);
        const float dd = s0 == 0 ? node(dden, v, n, h, head) : 0.f;  // its term once
        float dn[FP];
        load_cols<FP>(dn, dnum, v, n, hf, head * f + s0, fw);
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          __syncthreads();  // the logits are staged; the previous slabs are no longer read
          stage_tiles(s_sh, S, FP, s2, cols_sh + g0, gn, n, hf, head * f + s0, fw, col_unit<ANY>);
          __syncthreads();
          for (int t = g0; t < g0 + gn; ++t)
            receiver_walk<FP>(mask_sh[t * TM + i], ls_sh + t * TK * HS + (head - h0), HS,
                              s_sh + (t - g0) * TK * S, ld, mv, dn, dd, slope, acc);
        }
      }
      if (dst != nullptr) dst[head] = acc;
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    sum_parts<ANY>(geo, it, ws, h, dldst_out, nullptr, n, h);
}

// B6, over the transpose tiles: blockIdx.x is a work item of their own
// schedule; thread i owns sender u and keeps s2_u's slab and ds in
// registers. The receivers' ldst, m and dden of `hc` heads at a time are
// staged once per item, each head's dnum slab of `group` tiles in one batch.
// A part of a split row is [TM][H F + H]: ds, then dlsrc.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_bwd_sender_item_kernel(const void* __restrict__ tiles_t, int bf16,
                           const int* __restrict__ block_cols, const int* __restrict__ items,
                           Geo geo, const float* __restrict__ lsrc, const float* __restrict__ ldst,
                           const float* __restrict__ s2, const float* __restrict__ m_in,
                           const float* __restrict__ dnum, const float* __restrict__ dden,
                           float* __restrict__ ds_out, float* __restrict__ dlsrc_out,
                           float* __restrict__ ws, int* __restrict__ counters, int n, int h,
                           int f, int max_tiles, int group, int hc, float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  const int node_floats = max_tiles * TK * (hc | 1);
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                   // [C][TM]: own words
  float* dn_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);  // [group][TK][S]
  float* ld_sh = dn_sh + group * TK * S;                              // [C][TK][hc | 1]
  float* m_sh = ld_sh + node_floats;                                  // [C][TK][hc | 1]
  float* dd_sh = m_sh + node_floats;                                  // [C][TK][hc | 1]
  int* cols_sh = reinterpret_cast<int*>(dd_sh + node_floats);         // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long u = own_node<ANY>(geo, it.row, n);  // sender
  float* const dst_ds = grad_row(it, ws, hf + h, 0, ds_out, hf, u, n);
  float* const dst_dl = grad_row(it, ws, hf + h, hf, dlsrc_out, h, u, n);
  load_item_tiles<ANY>(geo, it, tiles_t, bf16, block_cols, mask_sh, cols_sh);

  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering random receivers hit distinct banks
    __syncthreads();  // cols_sh; the previous heads' receivers are no longer read
    stage_tiles(ld_sh, HS, hn, ldst, cols_sh, nt, n, h, h0, hn, col_unit<ANY>);
    stage_tiles(m_sh, HS, hn, m_in, cols_sh, nt, n, h, h0, hn, col_unit<ANY>);
    stage_tiles(dd_sh, HS, hn, dden, cols_sh, nt, n, h, h0, hn, col_unit<ANY>);
    for (int head = h0; head < h0 + hn; ++head) {
      const float lu = node(lsrc, u, n, h, head);
      float dl = 0.f;
      for (int s0 = 0; s0 < f; s0 += FP) {
        const int fw = min(FP, f - s0);
        const bool first = s0 == 0;  // dden's term once
        float su[FP], ds[FP];
        load_cols<FP>(su, s2, u, n, hf, head * f + s0, fw);
#pragma unroll
        for (int k = 0; k < FP; ++k) ds[k] = 0.f;
        for (int g0 = 0; g0 < nt; g0 += group) {
          const int gn = min(group, nt - g0);
          __syncthreads();  // the receivers are staged; the previous slabs are no longer read
          stage_tiles(dn_sh, S, FP, dnum, cols_sh + g0, gn, n, hf, head * f + s0,
                      fw, col_unit<ANY>);
          __syncthreads();
          for (int t = g0; t < g0 + gn; ++t) {
            const int base = t * TK * HS + (head - h0);
            sender_walk<FP>(mask_sh[t * TM + i], ld_sh + base, m_sh + base, dd_sh + base, HS,
                            dn_sh + (t - g0) * TK * S, lu, su, first, slope, ds, dl);
          }
        }
        put_cols<FP>(dst_ds, head * f + s0, fw, ds);
      }
      if (dst_dl != nullptr) dst_dl[head] = dl;
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    sum_parts<ANY>(geo, it, ws, hf + h, ds_out, dlsrc_out, n, hf);
}

// B5s, merged: one CTA per forward tile for all heads, thread i on receiver v
// (row i of the tile's block row); the mask decoded once into registers. The
// tile's senders' lsrc of `hc` heads at a time (all unless the card's shared
// memory forbids it) are staged at the odd stride hc | 1, per head the
// tile's s2 slab; B5's walk (receiver_walk) per slab, dnum_v's slab in
// registers, then the row's sum added into the zero-filled dldst by one f32
// reduction per (row, head), by rows with an own edge. Rows past n, or
// without an own edge, take every barrier and read nothing of their own.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_bwd_dldst_stream_kernel(const void* __restrict__ tiles, int bf16,
                            const int* __restrict__ block_cols,
                            const int* __restrict__ block_rows, Geo geo,
                            const float* __restrict__ lsrc, const float* __restrict__ ldst,
                            const float* __restrict__ s2,
                            const float* __restrict__ m_in, const float* __restrict__ dnum,
                            const float* __restrict__ dden, float* __restrict__ dldst_out, int n,
                            int h, int f, int hc, float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sh = reinterpret_cast<float*>(smem);  // [TK][S]
  float* ls_sh = s_sh + TK * S;                  // [TK][hc | 1]
  const int t = blockIdx.x, i = threadIdx.x, hf = h * f;
  const long long v = own_node<ANY>(geo, block_rows[t], n);    // receiver
  const long long col0 = first_node<ANY>(geo, block_cols[t]);  // senders
  const uint4 own = panel_mask<ANY>(geo, tiles, bf16, t, block_rows[t], block_cols[t]);
  const bool live = v < n && (own.x | own.y | own.z | own.w) != 0;
  const long long vr = live ? v : n;  // a row past n reads zeros

  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering the logits of random senders hit distinct banks
    __syncthreads();  // the previous heads' logits are no longer read
    stage_rows(ls_sh, HS, hn, lsrc, col0, n, h, h0, hn);
    for (int head = h0; head < h0 + hn; ++head) {
      const float ld = node(ldst, vr, n, h, head), mv = node(m_in, vr, n, h, head);
      float acc = 0.f;
      for (int s0 = 0; s0 < f; s0 += FP) {
        const int fw = min(FP, f - s0);
        const float dd = s0 == 0 ? node(dden, vr, n, h, head) : 0.f;  // its term once
        float dn[FP];
        load_cols<FP>(dn, dnum, vr, n, hf, head * f + s0, fw);
        __syncthreads();  // the logits are staged; the previous slab is no longer read
        stage_rows(s_sh, S, FP, s2, col0, n, hf, head * f + s0, fw);
        __syncthreads();
        if (live)
          receiver_walk<FP>(own, ls_sh + (head - h0), HS, s_sh, ld, mv, dn, dd, slope, acc);
      }
      if (live) atomicAdd(dldst_out + v * h + head, acc);
    }
  }
}

// B6s: one CTA per transpose tile for all heads, thread i on sender u; the
// mask decoded once into registers. The receivers' ldst, m and dden of `hc`
// heads at a time (all unless the card's shared memory forbids it) are staged
// at the odd stride hc | 1, per head the tile's dnum slab; B6's walk
// (sender_walk) per slab, then ds's slab and, after the last, dlsrc added
// into the zero-filled outputs by f32 reductions, by rows with an own edge.
template <int FP, bool ANY>
__global__ void __launch_bounds__(THREADS)
gat_bwd_sender_stream_kernel(const void* __restrict__ tiles_t, int bf16,
                             const int* __restrict__ block_cols,
                             const int* __restrict__ block_rows, Geo geo,
                             const float* __restrict__ lsrc, const float* __restrict__ ldst,
                             const float* __restrict__ s2,
                             const float* __restrict__ m_in, const float* __restrict__ dnum,
                             const float* __restrict__ dden, float* __restrict__ ds_out,
                             float* __restrict__ dlsrc_out, int n, int h, int f, int hc,
                             float slope) {
  constexpr int S = slab_stride(FP);
  extern __shared__ __align__(16) unsigned char smem[];
  const int node_floats = TK * (hc | 1);
  float* dn_sh = reinterpret_cast<float*>(smem);  // [TK][S]
  float* ld_sh = dn_sh + TK * S;                  // [TK][hc | 1]
  float* m_sh = ld_sh + node_floats;              // [TK][hc | 1]
  float* dd_sh = m_sh + node_floats;              // [TK][hc | 1]
  const int t = blockIdx.x, i = threadIdx.x, hf = h * f;
  const long long u = own_node<ANY>(geo, block_rows[t], n);    // sender
  const long long col0 = first_node<ANY>(geo, block_cols[t]);  // receivers
  const uint4 own = panel_mask<ANY>(geo, tiles_t, bf16, t, block_rows[t], block_cols[t]);
  const bool live = u < n && (own.x | own.y | own.z | own.w) != 0;
  const bool quads = f % 4 == 0;

  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hn = min(hc, h - h0);
    const int HS = hn | 1;  // odd: lanes gathering random receivers hit distinct banks
    __syncthreads();  // the previous heads' receivers are no longer read
    stage_rows(ld_sh, HS, hn, ldst, col0, n, h, h0, hn);
    stage_rows(m_sh, HS, hn, m_in, col0, n, h, h0, hn);
    stage_rows(dd_sh, HS, hn, dden, col0, n, h, h0, hn);
    for (int head = h0; head < h0 + hn; ++head) {
      const float lu = node(lsrc, u, n, h, head);
      float dl = 0.f;
      for (int s0 = 0; s0 < f; s0 += FP) {
        const int fw = min(FP, f - s0);
        float su[FP], ds[FP];
        load_cols<FP>(su, s2, u, n, hf, head * f + s0, fw);
#pragma unroll
        for (int k = 0; k < FP; ++k) ds[k] = 0.f;
        __syncthreads();  // the receivers are staged; the previous slab is no longer read
        stage_rows(dn_sh, S, FP, dnum, col0, n, hf, head * f + s0, fw);
        __syncthreads();
        if (!live) continue;
        const int at = head - h0;
        sender_walk<FP>(own, ld_sh + at, m_sh + at, dd_sh + at, HS, dn_sh, lu, su, s0 == 0,
                        slope, ds, dl);
        add_cols<FP>(ds_out + u * hf + static_cast<long long>(head) * f + s0, fw, ds, quads);
      }
      if (live) atomicAdd(dlsrc_out + u * h + head, dl);
    }
  }
}

// The item kernels' tile group (the s2 or dnum slabs staged at once) at
// width fp and C = max_tiles, and their dynamic shared memory with the
// `arrays` node arrays (B3, B5: lsrc; B6: ldst, m, dden) of hc heads staged.
int item_group(int fp, int max_tiles) {
  return tile_group(sizeof(float) * TK * slab_stride(fp), max_tiles);
}
size_t item_smem(int fp, int hc, int max_tiles, int arrays) {
  return static_cast<size_t>(max_tiles) * (TM * sizeof(uint4) + sizeof(int)) +
         sizeof(float) * TK *
             (static_cast<size_t>(item_group(fp, max_tiles)) * slab_stride(fp) +
              static_cast<size_t>(arrays) * max_tiles * (hc | 1));
}

// The stream kernels' dynamic shared memory: `arrays` node arrays of hc heads
// for a tile's 128 columns (B4a, B4b, B5s: lsrc; B6s: ldst, m, dden), and
// with them (B4b, B5s, B6s) the column side's slab of width fp (s2, or dnum).
size_t node_smem(int hc, int arrays) {
  return sizeof(float) * TK * static_cast<size_t>(arrays) * (hc | 1);
}
size_t stream_smem(int fp, int hc, int arrays) {
  return sizeof(float) * TK * slab_stride(fp) + node_smem(hc, arrays);
}

// The heads whose node arrays B3-B6, B4 and B5s-B6s stage at once, given the
// shared memory `smem(hc)` a kernel takes with hc of them: all h unless that
// would outgrow the card's (then the kernel walks them in groups of hc,
// restaging between).
template <typename Smem>
int staged_heads(int h, Smem smem) {
  int hc = h;
  while (hc > 1 && smem(hc) > MAX_SMEM) --hc;
  return hc;
}

}  // namespace

extern "C" {

// The rows of one CTA's panel, the multiple that tile sides must be, and the
// ints of one work item of B3, B5 and B6.
int gat_tile_attn_config(int* panel, int* side_multiple, int* item_ints) {
  *panel = TM;
  *side_multiple = 32;
  *item_ints = ITEM_INTS;
  return 0;
}

// Each entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments it does not take. Every entry takes the
// tile geometry: side S, panels P and the panel tiles' source tiles `src`
// (gat_tile_common.cuh); block_cols, block_rows and items are the panel
// tiles' (the tiles' own when P = 1).

// B3: num [n, H*F], den, m [n, H]. items: the schedule [n_items, ITEM_INTS] at
// C = max_tiles; ws: the partials of n_slots split items (n_slots * TM *
// (H*F + 2H) floats; null when n_slots is 0); counters: n_slots ints, zero
// between launches.
int gat_tile_fwd(const void* tiles, const void* block_cols, const void* items, const void* lsrc,
                 const void* ldst, const void* s2, void* num, void* den, void* m, void* ws,
                 void* counters, int n_items, int n_slots, int n, int h, int f, int max_tiles,
                 int tile_bf16, int side, int panels, const void* src, float slope,
                 void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || h < 1 || max_tiles < 1 || !geo_ok(geo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  const int hc = staged_heads(h, [&](int c) { return item_smem(fp, c, max_tiles, 1); });
  return by_geometry(geo, [&](auto any) {
    return launch(pick_width(f, GAT_TILE_WIDTHS(gat_fwd_item_kernel, decltype(any)::value)),
                  dim3(n_items), item_smem(fp, hc, max_tiles, 1), stream, tiles, tile_bf16,
                  static_cast<const int*>(block_cols), static_cast<const int*>(items), geo,
                  static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
                  static_cast<const float*>(s2), static_cast<float*>(num),
                  static_cast<float*>(den), static_cast<float*>(m), static_cast<float*>(ws),
                  static_cast<int*>(counters), n_slots, n, h, f, max_tiles,
                  item_group(fp, max_tiles), hc, slope);
  });
}

// B4, merged: num [n, H*F] and den [n, H] zero-filled and m [n, H] filled
// with NEG by the caller; bits: [T][TM] 16-byte mask words (T panel tiles),
// written by B4a and read by B4b, the two kernels launched one after the
// other on `stream`.
int gat_tile_fwd_stream(const void* tiles, const void* block_cols, const void* block_rows,
                        const void* lsrc, const void* ldst, const void* s2, void* num, void* den,
                        void* m, void* bits, int n_tiles, int n, int h, int f, int tile_bf16,
                        int side, int panels, const void* src, float slope, void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || h < 1 || !geo_ok(geo)) return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  const int hc_max = staged_heads(h, [](int c) { return node_smem(c, 1); });
  const int hc_sum = staged_heads(h, [&](int c) { return stream_smem(fp, c, 1); });
  return by_geometry(geo, [&](auto any) {
    constexpr bool A = decltype(any)::value;
    const int err = launch(gat_fwd_stream_max_kernel<A>, dim3(n_tiles), node_smem(hc_max, 1),
                           stream, tiles, tile_bf16, static_cast<const int*>(block_cols),
                           static_cast<const int*>(block_rows), geo,
                           static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
                           static_cast<float*>(m), static_cast<uint4*>(bits), n, h, hc_max,
                           slope);
    if (err) return err;
    return launch(pick_width(f, GAT_TILE_WIDTHS(gat_fwd_stream_sum_kernel, A)), dim3(n_tiles),
                  stream_smem(fp, hc_sum, 1), stream, static_cast<const int*>(block_cols),
                  static_cast<const int*>(block_rows), geo, static_cast<const uint4*>(bits),
                  static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
                  static_cast<const float*>(s2), static_cast<const float*>(m),
                  static_cast<float*>(num), static_cast<float*>(den), n, h, f, hc_sum, slope);
  });
}

// B5 over the forward tiles, on B3's work items (the same schedule and
// counters: the wrapper launches the two one after the other on one stream):
// dldst [n, H]; the split rows' partials in ws [n_slots][TM][H].
int gat_tile_bwd_dldst(const void* tiles, const void* block_cols, const void* items,
                       const void* lsrc, const void* ldst, const void* s2, const void* m,
                       const void* dnum, const void* dden, void* dldst, void* ws, void* counters,
                       int n_items, int n_slots, int n, int h, int f, int max_tiles,
                       int tile_bf16, int side, int panels, const void* src, float slope,
                       void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || h < 1 || max_tiles < 1 || n_slots < 0 || !geo_ok(geo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  const int hc = staged_heads(h, [&](int c) { return item_smem(fp, c, max_tiles, 1); });
  return by_geometry(geo, [&](auto any) {
    return launch(
        pick_width(f, GAT_TILE_WIDTHS(gat_bwd_dldst_item_kernel, decltype(any)::value)),
        dim3(n_items), item_smem(fp, hc, max_tiles, 1), stream, tiles, tile_bf16,
        static_cast<const int*>(block_cols), static_cast<const int*>(items), geo,
        static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
        static_cast<const float*>(s2), static_cast<const float*>(m),
        static_cast<const float*>(dnum), static_cast<const float*>(dden),
        static_cast<float*>(dldst), static_cast<float*>(ws), static_cast<int*>(counters), n, h,
        f, max_tiles, item_group(fp, max_tiles), hc, slope);
  });
}

// B5s over the forward tiles, merged: dldst [n, H], zero-filled by the
// caller.
int gat_tile_bwd_dldst_stream(const void* tiles, const void* block_cols, const void* block_rows,
                              const void* lsrc, const void* ldst, const void* s2, const void* m,
                              const void* dnum, const void* dden, void* dldst, int n_tiles,
                              int n, int h, int f, int tile_bf16, int side, int panels,
                              const void* src, float slope, void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || h < 1 || !geo_ok(geo)) return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  const int hc = staged_heads(h, [&](int c) { return stream_smem(fp, c, 1); });
  return by_geometry(geo, [&](auto any) {
    return launch(
        pick_width(f, GAT_TILE_WIDTHS(gat_bwd_dldst_stream_kernel, decltype(any)::value)),
        dim3(n_tiles), stream_smem(fp, hc, 1), stream, tiles, tile_bf16,
        static_cast<const int*>(block_cols), static_cast<const int*>(block_rows), geo,
        static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
        static_cast<const float*>(s2), static_cast<const float*>(m),
        static_cast<const float*>(dnum), static_cast<const float*>(dden),
        static_cast<float*>(dldst), n, h, f, hc, slope);
  });
}

// B6 over the transpose tiles (block rows are senders), on their own work
// items: ds [n, H*F], dlsrc [n, H]; the split rows' partials in
// ws [n_slots][TM][H*F + H].
int gat_tile_bwd_sender(const void* tiles_t, const void* block_cols, const void* items,
                        const void* lsrc, const void* ldst, const void* s2, const void* m,
                        const void* dnum, const void* dden, void* ds, void* dlsrc, void* ws,
                        void* counters, int n_items, int n_slots, int n, int h, int f,
                        int max_tiles, int tile_bf16, int side, int panels, const void* src,
                        float slope, void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || h < 1 || max_tiles < 1 || n_slots < 0 || !geo_ok(geo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  const int hc = staged_heads(h, [&](int c) { return item_smem(fp, c, max_tiles, 3); });
  return by_geometry(geo, [&](auto any) {
    return launch(
        pick_width(f, GAT_TILE_WIDTHS(gat_bwd_sender_item_kernel, decltype(any)::value)),
        dim3(n_items), item_smem(fp, hc, max_tiles, 3), stream, tiles_t, tile_bf16,
        static_cast<const int*>(block_cols), static_cast<const int*>(items), geo,
        static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
        static_cast<const float*>(s2), static_cast<const float*>(m),
        static_cast<const float*>(dnum), static_cast<const float*>(dden),
        static_cast<float*>(ds), static_cast<float*>(dlsrc), static_cast<float*>(ws),
        static_cast<int*>(counters), n, h, f, max_tiles, item_group(fp, max_tiles), hc, slope);
  });
}

// B6s over the transpose tiles, merged: ds [n, H*F] and dlsrc [n, H],
// zero-filled by the caller.
int gat_tile_bwd_sender_stream(const void* tiles_t, const void* block_cols,
                               const void* block_rows, const void* lsrc, const void* ldst,
                               const void* s2, const void* m, const void* dnum, const void* dden,
                               void* ds, void* dlsrc, int n_tiles, int n, int h, int f,
                               int tile_bf16, int side, int panels, const void* src, float slope,
                               void* stream) {
  const Geo geo{side, panels, static_cast<const int*>(src)};
  if (f < 1 || h < 1 || !geo_ok(geo)) return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  const int hc = staged_heads(h, [&](int c) { return stream_smem(fp, c, 3); });
  return by_geometry(geo, [&](auto any) {
    return launch(
        pick_width(f, GAT_TILE_WIDTHS(gat_bwd_sender_stream_kernel, decltype(any)::value)),
        dim3(n_tiles), stream_smem(fp, hc, 3), stream, tiles_t, tile_bf16,
        static_cast<const int*>(block_cols), static_cast<const int*>(block_rows), geo,
        static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
        static_cast<const float*>(s2), static_cast<const float*>(m),
        static_cast<const float*>(dnum), static_cast<const float*>(dden),
        static_cast<float*>(ds), static_cast<float*>(dlsrc), n, h, f, hc, slope);
  });
}

}  // extern "C"
