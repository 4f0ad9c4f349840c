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
// Design. The TPU grid runs the tiles in order and carries a block row's
// running max, num and den in a revisited output block. Here one CTA of 128
// threads owns one (head, block row): blockIdx.x = block_row * H + head, so
// the H CTAs of a block row are scheduled together and read its tiles once
// from device memory and H - 1 times from L2. It loops over the row's tiles
// (block_row_ptr[r] .. [r+1]); thread i owns row i of the block and keeps its
// state (m, den, num[F] for B3; dnum_v[F] and the sum for B5; s2_u[F], ds[F]
// and the sum for B6) in registers across the tiles. Each output is written
// once, with no atomics, so results are deterministic. A block row without
// tiles writes num = den = 0 and m = NEG (B3) and zero gradients.
//
// Per tile the CTA stages the column side's operands for its head in shared
// memory (B3/B5: lsrc and s2 of the 128 senders; B6: ldst, m, dden and dnum of
// the 128 receivers). The mask is never stored: four warp ballots a row give
// each thread its row's 128 mask bits, and the warp walks the columns that any
// of its 32 rows needs (gat_tile_common.cuh), evaluating every (row, column)
// slot there, selecting, never multiplying, by
// the mask: exp(NEG - NEG) = 1 must not leak in. B3 takes the tile's row max
// first, rescales by corr = exp(m_old - m_new) (1 with den = 0 for a row still
// at NEG) and then accumulates, the flash order of the TPU kernel.
//
// Per-tile ("stream") modes, the kernels' STREAM template parameter. They
// replace the TILE_REVISIT = False path of the TPU file: B4 is
// _fwd_kernel_stream, B5s and B6s are _bwd_dldst_kernel and _bwd_sender_kernel
// with stream=True. One CTA owns one (head, tile): blockIdx.x = tile * H + head,
// its block row is block_rows[tile], and it runs the body above over that one
// tile and writes the tile's block of TM rows (all of them, rows past n
// included) into per-tile outputs [T, TM, W], which the caller merges. B4's
// max is the tile's own row max (NEG where the row has no edge there, with
// num = den = 0 then); the merge rescales the tiles onto the block row's max.
// B5s and B6s read the merged max m. The grid has H * T CTAs instead of
// H * (block rows), so no block row with many tiles sets the launch's tail,
// at the price of writing the blocks (at 8 heads x 8: num_t 0.09 GB) and
// merging them.
//
// Bound on an H100 SXM at the ogbn-arxiv hybrid (2863 f32 tiles, 3.1M tile
// edges, N = 169,343; layer 1 H = 8, F = 8): each launch must read the tiles as
// stored (0.19 GB) plus O(N (H + H F)) bytes of operands and outputs (about
// 0.1 GB), about 0.09 ms at 3.35 TB/s; its 20-40 operations per edge and head
// take under 0.01 ms at the 67 TFLOP/s f32 rate: bound by bytes. This design
// reads the tiles from L2 H times and evaluates about 90% of the slots of a
// 7%-full tile (a column is skipped only when all 32 rows of the warp lack it),
// an exp and F to 2F FMAs each, which keeps it above the bound. Skipping by
// edge lists, tensor cores for the F-wide products and TMA staging are left
// to later work.
//
// Precision: expf (not __expf) and f32 FMA, no TF32, so the kernels match their
// plain PyTorch versions to rounding. Ragged shapes are masked in the kernel:
// rows of operands past n read as zero and output rows past n are not
// written, so nothing is padded by a copy. Per-head widths F <= MAX_F are
// padded in registers to the next compiled width FP. Plain C interface,
// loaded with ctypes.

#include "gat_tile_common.cuh"

namespace {

using namespace gat_tile;

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
gat_fwd_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
               const int* __restrict__ rows, const float* __restrict__ lsrc,
               const float* __restrict__ ldst, const float* __restrict__ s2,
               float* __restrict__ num_out, float* __restrict__ den_out,
               float* __restrict__ m_out, int n, int h, int f, float slope) {
  __shared__ __align__(16) float s_sh[TK * FP];
  __shared__ float ls_sh[TK];
  const int head = blockIdx.x % h, blk = blockIdx.x / h;
  int t_begin, t_end;
  const int br = tile_run<STREAM>(rows, blk, &t_begin, &t_end);
  const int hf = h * f;
  const long long v = static_cast<long long>(br) * TM + threadIdx.x;
  const float ld = node(ldst, v, n, h, head);
  float m = NEG, den = 0.f, acc[FP];
#pragma unroll
  for (int k = 0; k < FP; ++k) acc[k] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;
    __syncthreads();  // the previous tile's slabs are no longer read
    ls_sh[threadIdx.x] = node(lsrc, col0 + threadIdx.x, n, h, head);
    stage_feats<FP>(s_sh, s2, col0, n, hf, head, f);
    uint32_t w[4];
    mask_words(tile_ptr(tiles, bf16, t), bf16, w);
    __syncthreads();

    float tmax = NEG;
    for_columns(w, [&](int j, bool on) {
      const float e = leaky(ld + ls_sh[j], slope);
      if (on) tmax = fmaxf(tmax, e);
    });
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // NEG - NEG: 1, with den still 0
    den *= corr;
#pragma unroll
    for (int k = 0; k < FP; ++k) acc[k] *= corr;
    m = m_new;
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
  }
  const long long o = out_row<STREAM>(blk, v, n);
  if (o >= 0) {
    float* dst = num_out + o * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) dst[k] = acc[k];
    den_out[o * h + head] = den;
    m_out[o * h + head] = m;
  }
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
  const float dd = node(dden, v, n, h, head);
  float dn[FP];
#pragma unroll
  for (int k = 0; k < FP; ++k)
    dn[k] = (v < n && k < f) ? dnum[v * hf + static_cast<long long>(head) * f + k] : 0.f;
  float acc = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;
    __syncthreads();
    ls_sh[threadIdx.x] = node(lsrc, col0 + threadIdx.x, n, h, head);
    stage_feats<FP>(s_sh, s2, col0, n, hf, head, f);
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
  float su[FP], ds[FP];
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    su[k] = (u < n && k < f) ? s2[u * hf + static_cast<long long>(head) * f + k] : 0.f;
    ds[k] = 0.f;
  }
  float dl = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;  // receivers
    __syncthreads();
    ld_sh[threadIdx.x] = node(ldst, col0 + threadIdx.x, n, h, head);
    m_sh[threadIdx.x] = node(m_in, col0 + threadIdx.x, n, h, head);
    dd_sh[threadIdx.x] = node(dden, col0 + threadIdx.x, n, h, head);
    stage_feats<FP>(dn_sh, dnum, col0, n, hf, head, f);
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
  const long long o = out_row<STREAM>(blk, u, n);
  if (o >= 0) {
    float* dst = ds_out + o * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) dst[k] = ds[k];
    dlsrc_out[o * h + head] = dl;
  }
}

// GAT_TILE_WIDTHS for kernels that also take the mode S.
#define GAT_WIDTHS_OF_MODE(kernel, S) \
  kernel<4, S>, kernel<8, S>, kernel<16, S>, kernel<32, S>, kernel<40, S>, kernel<64, S>

// The launches, by mode. `rows` is block_row_ptr and `grid_rows` the block
// row count, or with S (stream) block_rows and the tile count.
template <bool S>
int launch_fwd(const void* tiles, const void* block_cols, const void* rows, const void* lsrc,
               const void* ldst, const void* s2, void* num, void* den, void* m, int grid_rows,
               int n, int h, int f, int tile_bf16, float slope, void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pick_width(f, GAT_WIDTHS_OF_MODE(gat_fwd_kernel, S));
  kernel<<<grid_of(grid_rows, h), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, tile_bf16, static_cast<const int*>(block_cols), static_cast<const int*>(rows),
      static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
      static_cast<const float*>(s2), static_cast<float*>(num), static_cast<float*>(den),
      static_cast<float*>(m), n, h, f, slope);
  return static_cast<int>(cudaGetLastError());
}

template <bool S>
int launch_dldst(const void* tiles, const void* block_cols, const void* rows, const void* lsrc,
                 const void* ldst, const void* s2, const void* m, const void* dnum,
                 const void* dden, void* dldst, int grid_rows, int n, int h, int f,
                 int tile_bf16, float slope, void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pick_width(f, GAT_WIDTHS_OF_MODE(gat_bwd_dldst_kernel, S));
  kernel<<<grid_of(grid_rows, h), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, tile_bf16, static_cast<const int*>(block_cols), static_cast<const int*>(rows),
      static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
      static_cast<const float*>(s2), static_cast<const float*>(m),
      static_cast<const float*>(dnum), static_cast<const float*>(dden),
      static_cast<float*>(dldst), n, h, f, slope);
  return static_cast<int>(cudaGetLastError());
}

template <bool S>
int launch_sender(const void* tiles_t, const void* block_cols, const void* rows,
                  const void* lsrc, const void* ldst, const void* s2, const void* m,
                  const void* dnum, const void* dden, void* ds, void* dlsrc, int grid_rows, int n,
                  int h, int f, int tile_bf16, float slope, void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pick_width(f, GAT_WIDTHS_OF_MODE(gat_bwd_sender_kernel, S));
  kernel<<<grid_of(grid_rows, h), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles_t, tile_bf16, static_cast<const int*>(block_cols), static_cast<const int*>(rows),
      static_cast<const float*>(lsrc), static_cast<const float*>(ldst),
      static_cast<const float*>(s2), static_cast<const float*>(m),
      static_cast<const float*>(dnum), static_cast<const float*>(dden),
      static_cast<float*>(ds), static_cast<float*>(dlsrc), n, h, f, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile shape and the largest per-head width the kernels are compiled for.
int gat_tile_attn_config(int* tm, int* tk, int* max_f) {
  *tm = TM;
  *tk = TK;
  *max_f = MAX_F;
  return 0;
}

// Each entry returns cudaGetLastError() after its launch.

// B3: num [n, H*F], den, m [n, H].
int gat_tile_fwd(const void* tiles, const void* block_cols, const void* block_row_ptr,
                 const void* lsrc, const void* ldst, const void* s2, void* num, void* den,
                 void* m, int n_block_rows, int n, int h, int f, int tile_bf16, float slope,
                 void* stream) {
  return launch_fwd<false>(tiles, block_cols, block_row_ptr, lsrc, ldst, s2, num, den, m,
                           n_block_rows, n, h, f, tile_bf16, slope, stream);
}

// B4: num_t [T, TM, H*F], den_t, max_t [T, TM, H].
int gat_tile_fwd_stream(const void* tiles, const void* block_cols, const void* block_rows,
                        const void* lsrc, const void* ldst, const void* s2, void* num_t,
                        void* den_t, void* max_t, int n_tiles, int n, int h, int f,
                        int tile_bf16, float slope, void* stream) {
  return launch_fwd<true>(tiles, block_cols, block_rows, lsrc, ldst, s2, num_t, den_t, max_t,
                          n_tiles, n, h, f, tile_bf16, slope, stream);
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
