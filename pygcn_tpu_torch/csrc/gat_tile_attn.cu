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
//   strides: every head's lsrc of the item's senders, staged once, and per
//   head the s2 slabs of all its tiles (or as many as fit in 48 KB), staged
//   in one batch of loads, so a head costs one round trip to memory and two
//   barriers.
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
// B5 and B6 (not redesigned): one CTA of 128 threads owns one (head, block
// row), blockIdx.x = block_row * H + head, so the H CTAs of a block row are
// scheduled together and read its tiles once from device memory and H - 1
// times from L2. It loops over the row's tiles; thread i keeps its row's
// state (dnum_v[F] and the sum for B5; s2_u[F], ds[F] and the sum for B6) in
// registers. Per tile the CTA stages the column side's operands for its head
// in shared memory (B5: lsrc and s2 of the 128 senders; B6: ldst, m, dden and
// dnum of the 128 receivers); the warp walks the columns that any of its 32
// rows needs (for_columns), selecting by the mask, never multiplying. Each
// output is written once, with no atomics. Both sums are linear in the
// F-wide dot products, so a wide head runs the tile loop once per 64-column
// slab, adding dden's term in the first.
//
// Per-tile ("stream") modes, the kernels' STREAM template parameter (B4 its
// own kernel). They replace the TILE_REVISIT = False path of the TPU file: B4
// is _fwd_kernel_stream, B5s and B6s are _bwd_dldst_kernel and
// _bwd_sender_kernel with stream=True. One CTA owns one (head, tile):
// blockIdx.x = tile * H + head, its block row is block_rows[tile], and it runs
// the body above over that one tile and writes the tile's block of TM rows
// (all of them, rows past n included) into per-tile outputs [T, TM, W], which
// the caller merges. B4's max is the tile's own row max (NEG where the row has
// no edge there, with num = den = 0 then); the merge rescales the tiles onto
// the block row's max. B5s and B6s read the merged max m.
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
// `group` tiles' s2 slabs are staged at once.
template <int FP>
__global__ void __launch_bounds__(THREADS)
gat_fwd_item_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                    const int* __restrict__ items, const float* __restrict__ lsrc,
                    const float* __restrict__ ldst, const float* __restrict__ s2,
                    float* __restrict__ num_out, float* __restrict__ den_out,
                    float* __restrict__ m_out, float* __restrict__ ws,
                    int* __restrict__ counters, int n_slots, int n, int h, int f,
                    int max_tiles, int group, float slope) {
  constexpr int S = slab_stride(FP);
  const int HS = h | 1;  // odd: lanes gathering the logits of random senders hit distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* mask_sh = reinterpret_cast<uint4*>(smem);                   // [C][TM]: own words
  float* s_sh = reinterpret_cast<float*>(mask_sh + max_tiles * TM);   // [group][TK][S]
  float* ls_sh = s_sh + group * TK * S;                               // [C][TK][HS]
  int* cols_sh = reinterpret_cast<int*>(ls_sh + max_tiles * TK * HS);  // [C]
  const Item it = load_item(items);
  const int nt = it.end - it.begin, i = threadIdx.x, hf = h * f;
  const long long v = static_cast<long long>(it.row) * TM + i;
  const Partials parts(ws, n_slots, h, hf);

  if (i < nt) cols_sh[i] = block_cols[it.begin + i];
  for (int t = 0; t < nt; ++t) {
    uint32_t w[4];
    mask_words(tile_ptr(tiles, bf16, it.begin + t), bf16, w);
    mask_sh[t * TM + i] = make_uint4(w[0], w[1], w[2], w[3]);  // read by this thread only
  }
  __syncthreads();  // cols_sh
  stage_tiles(ls_sh, HS, h, lsrc, cols_sh, nt, n, h, 0, h);  // every head's sender logits
  __syncthreads();
  for (int head = 0; head < h; ++head) {
    const float ld = node(ldst, v, n, h, head);
    for (int s0 = 0; s0 < f; s0 += FP) {
      const int fw = min(FP, f - s0);
      float m = NEG, den = 0.f, acc[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) acc[k] = 0.f;
      for (int g0 = 0; g0 < nt; g0 += group) {
        const int gn = min(group, nt - g0);
        __syncthreads();  // the previous slabs are no longer read
        stage_tiles(s_sh, S, FP, s2, cols_sh + g0, gn, n, hf, head * f + s0, fw);
        __syncthreads();
        for (int t = g0; t < g0 + gn; ++t) {
          const float* ls = ls_sh + t * TK * HS + head;
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
      put_softmax<FP>(it, parts, num_out, den_out, m_out, v, n, h, hf, head, f, s0, fw, acc, den,
                      m);
    }
  }
  if (it.slot >= 0 && arrive_last(counters + it.first, it.parts))
    merge_parts(it, parts, num_out, den_out, m_out, n, h, hf);
}

// B4: one CTA per (head, tile); writes the tile's block of num_t [T, TM, H*F],
// den_t and max_t [T, TM, H].
template <int FP>
__global__ void __launch_bounds__(THREADS)
gat_fwd_stream_kernel(const void* __restrict__ tiles, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ block_rows,
                      const float* __restrict__ lsrc, const float* __restrict__ ldst,
                      const float* __restrict__ s2, float* __restrict__ num_out,
                      float* __restrict__ den_out, float* __restrict__ m_out, int n, int h,
                      int f, float slope) {
  __shared__ __align__(16) float s_sh[TK * FP];
  __shared__ float ls_sh[TK];
  const int head = blockIdx.x % h, t = blockIdx.x / h;
  const int hf = h * f;
  const long long v = static_cast<long long>(block_rows[t]) * TM + threadIdx.x;
  const long long col0 = static_cast<long long>(block_cols[t]) * TK;
  const float ld = node(ldst, v, n, h, head);
  ls_sh[threadIdx.x] = node(lsrc, col0 + threadIdx.x, n, h, head);
  uint32_t w[4];
  mask_words(tile_ptr(tiles, bf16, t), bf16, w);
  __syncthreads();
  float m = NEG;
  for_columns(w, [&](int j, bool on) {
    const float e = leaky(ld + ls_sh[j], slope);
    if (on) m = fmaxf(m, e);
  });
  const long long o = static_cast<long long>(t) * TM + threadIdx.x;
  for (int s0 = 0; s0 < f; s0 += FP) {
    const int fw = min(FP, f - s0);
    __syncthreads();  // the previous slab is no longer read
    stage_rows(s_sh, FP, FP, s2, col0, n, hf, head * f + s0, fw);
    __syncthreads();
    float den = 0.f, acc[FP];
#pragma unroll
    for (int k = 0; k < FP; ++k) acc[k] = 0.f;
    for_columns(w, [&](int j, bool on) {
      const float e = leaky(ld + ls_sh[j], slope);
      const float p = on ? expf(e - m) : 0.f;
      den += p;
      const float4* sj = reinterpret_cast<const float4*>(s_sh + j * FP);
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 s = sj[q];
        acc[4 * q + 0] = fmaf(p, s.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(p, s.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(p, s.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(p, s.w, acc[4 * q + 3]);
      }
    });
    float* dst = num_out + o * hf + static_cast<long long>(head) * f + s0;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < fw) dst[k] = acc[k];
    if (s0 == 0) {
      den_out[o * h + head] = den;
      m_out[o * h + head] = m;
    }
  }
}

// The tiles CTA blk walks, [*t_begin, *t_end), and the block row they share:
// with STREAM, blk is a tile and `rows` the tiles' block_rows [T]; else blk is
// a block row and `rows` its block_row_ptr [n_block_rows + 1].
template <bool STREAM>
__device__ __forceinline__ int tile_run(const int* __restrict__ rows, int blk, int* t_begin,
                                        int* t_end) {
  if (STREAM) {
    *t_begin = blk;
    *t_end = blk + 1;
    return rows[blk];
  }
  *t_begin = rows[blk];
  *t_end = rows[blk + 1];
  return blk;
}

// The row of the output this thread writes, or -1 for none: its row v of the
// node space (v < n) or, with STREAM, row threadIdx.x of tile blk's block.
template <bool STREAM>
__device__ __forceinline__ long long out_row(int blk, long long v, int n) {
  if (STREAM) return static_cast<long long>(blk) * TM + threadIdx.x;
  return v < n ? v : -1;
}

template <int FP, bool STREAM>
__global__ void __launch_bounds__(THREADS)
gat_bwd_dldst_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                     const int* __restrict__ rows, const float* __restrict__ lsrc,
                     const float* __restrict__ ldst, const float* __restrict__ s2,
                     const float* __restrict__ m_in, const float* __restrict__ dnum,
                     const float* __restrict__ dden, float* __restrict__ dldst_out, int n,
                     int h, int f, float slope) {
  __shared__ __align__(16) float s_sh[TK * FP];
  __shared__ float ls_sh[TK];
  const int head = blockIdx.x % h, blk = blockIdx.x / h;
  int t_begin, t_end;
  const int br = tile_run<STREAM>(rows, blk, &t_begin, &t_end);
  const int hf = h * f;
  const long long v = static_cast<long long>(br) * TM + threadIdx.x;
  const float ld = node(ldst, v, n, h, head);
  const float mv = node(m_in, v, n, h, head);
  float acc = 0.f;

  for (int s0 = 0; s0 < f; s0 += FP) {
    const int fw = min(FP, f - s0);
    const float dd = s0 == 0 ? node(dden, v, n, h, head) : 0.f;  // its term once
    float dn[FP];
#pragma unroll
    for (int k = 0; k < FP; ++k)
      dn[k] = (v < n && k < fw) ? dnum[v * hf + static_cast<long long>(head) * f + s0 + k] : 0.f;
    for (int t = t_begin; t < t_end; ++t) {
      const long long col0 = static_cast<long long>(block_cols[t]) * TK;
      __syncthreads();
      ls_sh[threadIdx.x] = node(lsrc, col0 + threadIdx.x, n, h, head);
      stage_rows(s_sh, FP, FP, s2, col0, n, hf, head * f + s0, fw);
      uint32_t w[4];
      mask_words(tile_ptr(tiles, bf16, t), bf16, w);
      __syncthreads();

      for_columns(w, [&](int j, bool on) {
        const float pre = ld + ls_sh[j];
        const float p = on ? expf(leaky(pre, slope) - mv) : 0.f;
        const float4* sj = reinterpret_cast<const float4*>(s_sh + j * FP);
        float gdot = 0.f;
#pragma unroll
        for (int q = 0; q < FP / 4; ++q) {
          const float4 s = sj[q];
          gdot = fmaf(dn[4 * q + 0], s.x, gdot);
          gdot = fmaf(dn[4 * q + 1], s.y, gdot);
          gdot = fmaf(dn[4 * q + 2], s.z, gdot);
          gdot = fmaf(dn[4 * q + 3], s.w, gdot);
        }
        acc += p * (gdot + dd) * (pre >= 0.f ? 1.f : slope);
      });
    }
  }
  const long long o = out_row<STREAM>(blk, v, n);
  if (o >= 0) dldst_out[o * h + head] = acc;
}

template <int FP, bool STREAM>
__global__ void __launch_bounds__(THREADS)
gat_bwd_sender_kernel(const void* __restrict__ tiles_t, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ rows,
                      const float* __restrict__ lsrc, const float* __restrict__ ldst,
                      const float* __restrict__ s2, const float* __restrict__ m_in,
                      const float* __restrict__ dnum, const float* __restrict__ dden,
                      float* __restrict__ ds_out, float* __restrict__ dlsrc_out, int n, int h,
                      int f, float slope) {
  __shared__ __align__(16) float dn_sh[TK * FP];
  __shared__ float ld_sh[TK], m_sh[TK], dd_sh[TK];
  const int head = blockIdx.x % h, blk = blockIdx.x / h;
  int t_begin, t_end;
  const int br = tile_run<STREAM>(rows, blk, &t_begin, &t_end);
  const int hf = h * f;
  const long long u = static_cast<long long>(br) * TM + threadIdx.x;  // sender
  const float lu = node(lsrc, u, n, h, head);
  const long long o = out_row<STREAM>(blk, u, n);
  float dl = 0.f;

  for (int s0 = 0; s0 < f; s0 += FP) {
    const int fw = min(FP, f - s0);
    float su[FP], ds[FP];
#pragma unroll
    for (int k = 0; k < FP; ++k) {
      su[k] = (u < n && k < fw) ? s2[u * hf + static_cast<long long>(head) * f + s0 + k] : 0.f;
      ds[k] = 0.f;
    }
    for (int t = t_begin; t < t_end; ++t) {
      const long long col0 = static_cast<long long>(block_cols[t]) * TK;  // receivers
      __syncthreads();
      ld_sh[threadIdx.x] = node(ldst, col0 + threadIdx.x, n, h, head);
      m_sh[threadIdx.x] = node(m_in, col0 + threadIdx.x, n, h, head);
      dd_sh[threadIdx.x] = s0 == 0 ? node(dden, col0 + threadIdx.x, n, h, head) : 0.f;
      stage_rows(dn_sh, FP, FP, dnum, col0, n, hf, head * f + s0, fw);
      uint32_t w[4];
      mask_words(tile_ptr(tiles_t, bf16, t), bf16, w);
      __syncthreads();

      for_columns(w, [&](int j, bool on) {
        const float pre = lu + ld_sh[j];
        const float p = on ? expf(leaky(pre, slope) - m_sh[j]) : 0.f;
        const float4* dj = reinterpret_cast<const float4*>(dn_sh + j * FP);
        float gdot = 0.f;
#pragma unroll
        for (int q = 0; q < FP / 4; ++q) {
          const float4 d = dj[q];
          ds[4 * q + 0] = fmaf(p, d.x, ds[4 * q + 0]);
          ds[4 * q + 1] = fmaf(p, d.y, ds[4 * q + 1]);
          ds[4 * q + 2] = fmaf(p, d.z, ds[4 * q + 2]);
          ds[4 * q + 3] = fmaf(p, d.w, ds[4 * q + 3]);
          gdot = fmaf(su[4 * q + 0], d.x, gdot);
          gdot = fmaf(su[4 * q + 1], d.y, gdot);
          gdot = fmaf(su[4 * q + 2], d.z, gdot);
          gdot = fmaf(su[4 * q + 3], d.w, gdot);
        }
        dl += p * (gdot + dd_sh[j]) * (pre >= 0.f ? 1.f : slope);
      });
    }
    if (o >= 0) {
      float* dst = ds_out + o * hf + static_cast<long long>(head) * f + s0;
#pragma unroll
      for (int k = 0; k < FP; ++k)
        if (k < fw) dst[k] = ds[k];
    }
  }
  if (o >= 0) dlsrc_out[o * h + head] = dl;
}

// GAT_TILE_WIDTHS for kernels that also take the mode S.
#define GAT_WIDTHS_OF_MODE(kernel, S) \
  kernel<4, S>, kernel<8, S>, kernel<16, S>, kernel<32, S>, kernel<40, S>, kernel<64, S>

// B3's tile group and dynamic shared memory at width fp, h heads and C = max_tiles.
int item_group(int fp, int max_tiles) {
  return tile_group(sizeof(float) * TK * slab_stride(fp), max_tiles);
}
size_t item_smem(int fp, int h, int max_tiles) {
  return static_cast<size_t>(max_tiles) * (TM * sizeof(uint4) + sizeof(int)) +
         sizeof(float) * TK *
             (static_cast<size_t>(item_group(fp, max_tiles)) * slab_stride(fp) +
              static_cast<size_t>(max_tiles) * (h | 1));
}

// The launches of B5/B6 by mode: `rows` is block_row_ptr and `grid_rows` the
// block row count, or with S (stream) block_rows and the tile count.
template <bool S>
int launch_dldst(const void* tiles, const void* block_cols, const void* rows, const void* lsrc,
                 const void* ldst, const void* s2, const void* m, const void* dnum,
                 const void* dden, void* dldst, int grid_rows, int n, int h, int f,
                 int tile_bf16, float slope, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_WIDTHS_OF_MODE(gat_bwd_dldst_kernel, S)), grid_of(grid_rows, h),
                0, stream, tiles, tile_bf16, static_cast<const int*>(block_cols),
                static_cast<const int*>(rows), static_cast<const float*>(lsrc),
                static_cast<const float*>(ldst), static_cast<const float*>(s2),
                static_cast<const float*>(m), static_cast<const float*>(dnum),
                static_cast<const float*>(dden), static_cast<float*>(dldst), n, h, f, slope);
}

template <bool S>
int launch_sender(const void* tiles_t, const void* block_cols, const void* rows,
                  const void* lsrc, const void* ldst, const void* s2, const void* m,
                  const void* dnum, const void* dden, void* ds, void* dlsrc, int grid_rows, int n,
                  int h, int f, int tile_bf16, float slope, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_WIDTHS_OF_MODE(gat_bwd_sender_kernel, S)),
                grid_of(grid_rows, h), 0, stream, tiles_t, tile_bf16,
                static_cast<const int*>(block_cols), static_cast<const int*>(rows),
                static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
                static_cast<const float*>(s2), static_cast<const float*>(m),
                static_cast<const float*>(dnum), static_cast<const float*>(dden),
                static_cast<float*>(ds), static_cast<float*>(dlsrc), n, h, f, slope);
}

}  // namespace

extern "C" {

// Tile shape and the ints of one work item of B3.
int gat_tile_attn_config(int* tm, int* tk, int* item_ints) {
  *tm = TM;
  *tk = TK;
  *item_ints = ITEM_INTS;
  return 0;
}

// Each entry returns cudaGetLastError() after its launch.

// B3: num [n, H*F], den, m [n, H]. items: the schedule [n_items, ITEM_INTS] at
// C = max_tiles; ws: the partials of n_slots split items (n_slots * TM *
// (H*F + 2H) floats; null when n_slots is 0); counters: n_slots ints, zero
// between launches.
int gat_tile_fwd(const void* tiles, const void* block_cols, const void* items, const void* lsrc,
                 const void* ldst, const void* s2, void* num, void* den, void* m, void* ws,
                 void* counters, int n_items, int n_slots, int n, int h, int f, int max_tiles,
                 int tile_bf16, float slope, void* stream) {
  if (f < 1 || max_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fp = width_of(f);
  return launch(pick_width(f, GAT_TILE_WIDTHS(gat_fwd_item_kernel)), dim3(n_items),
                item_smem(fp, h, max_tiles), stream, tiles, tile_bf16,
                static_cast<const int*>(block_cols), static_cast<const int*>(items),
                static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
                static_cast<const float*>(s2), static_cast<float*>(num), static_cast<float*>(den),
                static_cast<float*>(m), static_cast<float*>(ws), static_cast<int*>(counters),
                n_slots, n, h, f, max_tiles, item_group(fp, max_tiles), slope);
}

// B4: num_t [T, TM, H*F], den_t, max_t [T, TM, H].
int gat_tile_fwd_stream(const void* tiles, const void* block_cols, const void* block_rows,
                        const void* lsrc, const void* ldst, const void* s2, void* num_t,
                        void* den_t, void* max_t, int n_tiles, int n, int h, int f,
                        int tile_bf16, float slope, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_TILE_WIDTHS(gat_fwd_stream_kernel)), grid_of(n_tiles, h), 0,
                stream, tiles, tile_bf16, static_cast<const int*>(block_cols),
                static_cast<const int*>(block_rows), static_cast<const float*>(lsrc),
                static_cast<const float*>(ldst), static_cast<const float*>(s2),
                static_cast<float*>(num_t), static_cast<float*>(den_t),
                static_cast<float*>(max_t), n, h, f, slope);
}

// B5 over the forward tiles: dldst [n, H].
int gat_tile_bwd_dldst(const void* tiles, const void* block_cols, const void* block_row_ptr,
                       const void* lsrc, const void* ldst, const void* s2, const void* m,
                       const void* dnum, const void* dden, void* dldst, int n_block_rows,
                       int n, int h, int f, int tile_bf16, float slope, void* stream) {
  return launch_dldst<false>(tiles, block_cols, block_row_ptr, lsrc, ldst, s2, m, dnum, dden,
                             dldst, n_block_rows, n, h, f, tile_bf16, slope, stream);
}

// B5s over the forward tiles: dldst_t [T, TM, H].
int gat_tile_bwd_dldst_stream(const void* tiles, const void* block_cols, const void* block_rows,
                              const void* lsrc, const void* ldst, const void* s2, const void* m,
                              const void* dnum, const void* dden, void* dldst_t, int n_tiles,
                              int n, int h, int f, int tile_bf16, float slope, void* stream) {
  return launch_dldst<true>(tiles, block_cols, block_rows, lsrc, ldst, s2, m, dnum, dden,
                            dldst_t, n_tiles, n, h, f, tile_bf16, slope, stream);
}

// B6 over the transpose tiles (block rows are senders): ds [n, H*F], dlsrc [n, H].
int gat_tile_bwd_sender(const void* tiles_t, const void* block_cols, const void* block_row_ptr,
                        const void* lsrc, const void* ldst, const void* s2, const void* m,
                        const void* dnum, const void* dden, void* ds, void* dlsrc,
                        int n_block_rows, int n, int h, int f, int tile_bf16, float slope,
                        void* stream) {
  return launch_sender<false>(tiles_t, block_cols, block_row_ptr, lsrc, ldst, s2, m, dnum,
                              dden, ds, dlsrc, n_block_rows, n, h, f, tile_bf16, slope, stream);
}

// B6s over the transpose tiles: ds_t [Tt, TM, H*F], dlsrc_t [Tt, TM, H].
int gat_tile_bwd_sender_stream(const void* tiles_t, const void* block_cols,
                               const void* block_rows, const void* lsrc, const void* ldst,
                               const void* s2, const void* m, const void* dnum, const void* dden,
                               void* ds_t, void* dlsrc_t, int n_tiles, int n, int h, int f,
                               int tile_bf16, float slope, void* stream) {
  return launch_sender<true>(tiles_t, block_cols, block_rows, lsrc, ldst, s2, m, dnum, dden,
                             ds_t, dlsrc_t, n_tiles, n, h, f, tile_bf16, slope, stream);
}

}  // extern "C"
