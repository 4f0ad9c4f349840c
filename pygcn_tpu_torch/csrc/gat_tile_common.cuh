// What the GAT tile-attention kernels share (gat_tile_attn.cu: B3-B6, B4,
// B5s, B6s; gatv2_tile_attn.cu: B7/B8/B9): the tile shape, the mask read by
// warp ballots, the walk over a row's own edges, operand staging, the
// per-width kernel pick, the work items of the item-scheduled kernels (B3,
// B5, B6, B7, B8, B9): their masks decoded once per item, the flash merge of
// B3's and B7's split rows, and the in-order sum of the backward kernels'
// split rows; B5's and B6's per-edge walks, which B5s and B6s share; and the
// reductions that merge the stream kernels' tiles (B4, B5s, B6s).
//
// The mask is decoded from the tile itself (only B4 keeps its words in device
// memory, a bits buffer its first kernel writes for its second): warp w reads
// rows 32w..32w+31 of a tile, one 16-byte (f32) or 8-byte (bf16) load a lane
// per row, and four ballots give that row's 128 mask bits (bit l of word c is
// column 4l + c), which lane r keeps for its own row. Each thread then walks
// only its own row's set bits (for_own_edges), 8.5 of the 128 columns of a
// flagship tile on average, and reads the column side by per-lane gathers
// from a staged slab whose row stride is padded (slab_stride) so that eight
// lanes of a 16-byte access see eight banks.
//
// Tile shapes: every kernel is compiled for 128 x 128 tiles, the fast case,
// and (ANY) for square tiles of any side S that is a multiple of 32, read at
// run time from a Geo. A CTA always works on a panel of at most TM x TK of a
// tile, thread i on the panel's row i. A side of at most 128 is one panel:
// rows past S have no thread's node (own_node gives n) and columns past S no
// mask bit. A wider side is cut into P = ceil(S / 128) panels each way, and the
// wrapper hands the kernels its panel tiles in place of the tiles, sorted by
// panel block row: block row (or column) b of panels is panel b % P of tile
// block row b / P, its first node b / P * S + b % P * 128, and src[t] the
// tile of panel tile t. The staged slabs, the mask words and the workspace
// rows are sized for one panel, so no shared-memory cutoff depends on S and
// S has no upper bound.
//
// Per-head widths: a kernel compiled for width FP (4, 8, 16, 32, 40 or 64)
// takes any F: F <= 64 runs on the smallest FP >= F, with the last columns
// zero and never written; wider F runs FP = 64 over slabs of 64 columns (the
// last one ragged).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace gat_tile {

constexpr int TM = 128;  // rows of a panel (a 128 x 128 tile is one)
constexpr int TK = 128;  // columns of a panel
constexpr int THREADS = 128;  // one thread per tile row
constexpr int SLAB = 64;  // the widest compiled width: wider F loops over slabs of it
constexpr int ITEM_INTS = 6;  // a work item: begin, end, block row, slot, first slot, parts
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;  // what an H100 grants one CTA

static_assert(THREADS == TM, "one thread per tile row");

__device__ __forceinline__ float leaky(float x, float slope) { return x >= 0.f ? x : slope * x; }

// The tile geometry of an ANY kernel (see the top of this file).
struct Geo {
  int side;        // S, a multiple of 32
  int panels;      // P = ceil(S / 128)
  const int* src;  // the tile of each panel tile; null when P = 1 (the panel is the tile)
};

inline bool geo_ok(const Geo& g) {
  return g.side >= 32 && g.side % 32 == 0 && g.panels == (g.side + TM - 1) / TM &&
         (g.panels == 1 || g.src != nullptr);
}

// go(std::false_type) for 128 x 128 tiles (the fast case), else
// go(std::true_type) (the ANY kernels).
template <typename Go>
int by_geometry(const Geo& g, Go go) {
  if (g.side == TM) return go(std::false_type{});
  return go(std::true_type{});
}

// The first node of panel block row (or column) b.
template <bool ANY>
__device__ __forceinline__ long long first_node(const Geo& g, int b) {
  if constexpr (ANY) {
    return static_cast<long long>(b / g.panels) * g.side + (b % g.panels) * TM;
  } else {
    return static_cast<long long>(b) * TM;
  }
}

// The rows (or columns) of panel block b that lie in the tile.
template <bool ANY>
__device__ __forceinline__ int panel_extent(const Geo& g, int b) {
  if constexpr (ANY) {
    return min(TM, g.side - (b % g.panels) * TM);
  } else {
    return TM;
  }
}

// This thread's node on the row side of panel block row b: n (past every
// node) for a thread past the panel's rows.
template <bool ANY>
__device__ __forceinline__ long long own_node(const Geo& g, int b, int n) {
  const int i = threadIdx.x;
  if constexpr (ANY) {
    return i < panel_extent<true>(g, b) ? first_node<true>(g, b) + i : static_cast<long long>(n);
  } else {
    return static_cast<long long>(b) * TM + i;
  }
}

// The four mask words of this thread's row of a panel whose rows lie
// `stride` elements apart, `rows` x `cols` of it in the tile (ANY; multiples
// of 32, the rest reads as zero): bit l of word c is set when
// panel[row][4l + c] != 0 (-0 counts as zero, as in the plain version).
template <bool ANY>
__device__ __forceinline__ void mask_words(const void* tile, bool bf16, int stride, int rows,
                                           int cols, uint32_t w[4]) {
  const int lane = threadIdx.x & 31;
  const int row0 = threadIdx.x & ~31;
  const bool lane_in = !ANY || 4 * lane < cols;
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const size_t row = static_cast<size_t>(row0 + r) * (ANY ? stride : TK);
    bool nz0, nz1, nz2, nz3;
    if (ANY && (!lane_in || row0 + r >= rows)) {
      nz0 = nz1 = nz2 = nz3 = false;  // outside the tile: no edge
    } else if (bf16) {
      const uint2 b =
          __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(tile) + row) + lane);
      nz0 = (b.x & 0x7fffu) != 0;
      nz1 = (b.x & 0x7fff0000u) != 0;
      nz2 = (b.y & 0x7fffu) != 0;
      nz3 = (b.y & 0x7fff0000u) != 0;
    } else {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(tile) + row) + lane);
      nz0 = v.x != 0.f;
      nz1 = v.y != 0.f;
      nz2 = v.z != 0.f;
      nz3 = v.w != 0.f;
    }
    const uint32_t b0 = __ballot_sync(FULL, nz0), b1 = __ballot_sync(FULL, nz1);
    const uint32_t b2 = __ballot_sync(FULL, nz2), b3 = __ballot_sync(FULL, nz3);
    if (lane == r) {
      w[0] = b0;
      w[1] = b1;
      w[2] = b2;
      w[3] = b3;
    }
  }
}

__device__ __forceinline__ const void* tile_ptr(const void* tiles, bool bf16, int t) {
  return static_cast<const char*>(tiles) + static_cast<size_t>(t) * TM * TK * (bf16 ? 2 : 4);
}

// This thread's mask words of panel tile t at panel block (br, bc).
template <bool ANY>
__device__ __forceinline__ uint4 panel_mask(const Geo& g, const void* tiles, bool bf16, int t,
                                            int br, int bc) {
  uint32_t w[4];
  if constexpr (ANY) {
    const int p = br % g.panels, q = bc % g.panels;
    const size_t tile = g.src != nullptr ? g.src[t] : t;
    const size_t at = (tile * g.side + static_cast<size_t>(p) * TM) * g.side +
                      static_cast<size_t>(q) * TK;  // the panel's first element
    mask_words<true>(static_cast<const char*>(tiles) + at * (bf16 ? 2 : 4), bf16, g.side,
                     min(TM, g.side - p * TM), min(TK, g.side - q * TK), w);
  } else {
    mask_words<false>(tile_ptr(tiles, bf16, t), bf16, TK, TM, TK, w);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Calls body(j) for every column j where this thread's row has an edge, in
// the fixed order of its mask bits (word 0's bits first). Not warp-uniform:
// each lane walks its own edges, and the warp as long as its busiest lane.
template <typename Body>
__device__ __forceinline__ void for_own_edges(uint4 w, Body body) {
  unsigned long long lo = w.x | static_cast<unsigned long long>(w.y) << 32;
  unsigned long long hi = w.z | static_cast<unsigned long long>(w.w) << 32;
  while (lo | hi) {
    int b;
    if (lo) {
      b = __ffsll(static_cast<long long>(lo)) - 1;
      lo &= lo - 1;
    } else {
      b = 63 + __ffsll(static_cast<long long>(hi));
      hi &= hi - 1;
    }
    body(4 * (b & 31) + (b >> 5));  // bit l of word c is column 4l + c
  }
}

// Stage `blocks` blocks of TK rows of x [n, ld], columns c0 .. c0 + fw - 1,
// into xs [blocks][TK][stride] (width columns a row), zero past n and past
// fw: block t holds rows row0(t) .. row0(t) + TK - 1. Each thread issues its
// loads in batches before it stores any (16-byte loads when the columns and
// the stride are 4-aligned), so a staging costs about one round trip to
// memory rather than one per element.
template <typename Row0>
__device__ __forceinline__ void stage_blocks(float* __restrict__ xs, int stride, int width,
                                             const float* __restrict__ x, int blocks, Row0 row0,
                                             int n, int ld, int c0, int fw) {
  constexpr int U = 4;  // batches of U loads a thread
  if (((ld | c0 | width | stride) & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int quads = width / 4, per_block = TK * quads, total = blocks * per_block;
    for (int i0 = threadIdx.x; i0 < total; i0 += U * THREADS) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS, t = i / per_block, r = i % per_block;
        const int j = r / quads, k = (r % quads) * 4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && k < fw) {
          const long long row = row0(t) + j;
          if (row < n) {
            const float* src = x + row * ld + c0 + k;
            if (k + 4 <= fw) {
              v[u] = __ldg(reinterpret_cast<const float4*>(src));
            } else {  // the ragged last quad of the row
              v[u].x = __ldg(src);
              if (k + 1 < fw) v[u].y = __ldg(src + 1);
              if (k + 2 < fw) v[u].z = __ldg(src + 2);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS, t = i / per_block, r = i % per_block;
        if (i < total)
          *reinterpret_cast<float4*>(xs + (t * TK + r / quads) * stride + (r % quads) * 4) = v[u];
      }
    }
    return;
  }
  constexpr int US = 2 * U;  // scalar loads: twice as many in flight
  const int per_block = TK * width, total = blocks * per_block;
  for (int i0 = threadIdx.x; i0 < total; i0 += US * THREADS) {
    float v[US];
#pragma unroll
    for (int u = 0; u < US; ++u) {
      const int i = i0 + u * THREADS, t = i / per_block, r = i % per_block;
      const int j = r / width, k = r % width;
      v[u] = 0.f;
      if (i < total && k < fw) {
        const long long row = row0(t) + j;
        if (row < n) v[u] = __ldg(x + row * ld + c0 + k);
      }
    }
#pragma unroll
    for (int u = 0; u < US; ++u) {
      const int i = i0 + u * THREADS, t = i / per_block, r = i % per_block;
      if (i < total) xs[(t * TK + r / width) * stride + r % width] = v[u];
    }
  }
}

// One block of rows row0 .. row0 + TK - 1 (stage_blocks).
__device__ __forceinline__ void stage_rows(float* xs, int stride, int width, const float* x,
                                           long long row0, int n, int ld, int c0, int fw) {
  stage_blocks(xs, stride, width, x, 1, [=](int) { return row0; }, n, ld, c0, fw);
}

// The TK rows from node cols[t] * unit on under each of `blocks` consecutive
// (panel) tiles (stage_blocks): cols holds their block columns (unit TK, the
// fast case) or their first column nodes (unit 1, the ANY kernels; col_unit).
__device__ __forceinline__ void stage_tiles(float* xs, int stride, int width, const float* x,
                                            const int* cols, int blocks, int n, int ld, int c0,
                                            int fw, int unit) {
  stage_blocks(xs, stride, width, x, blocks,
               [=](int t) { return static_cast<long long>(cols[t]) * unit; }, n, ld, c0, fw);
}

template <bool ANY>
constexpr int col_unit = ANY ? 1 : TK;

// Row stride of a staged slab `width` floats wide (a multiple of 4): the
// smallest stride >= width that is 4 mod 8 words, so eight consecutive rows
// start in eight different 16-byte bank groups.
__host__ __device__ constexpr int slab_stride(int width) {
  return width % 8 ? width : width + 4;
}

__device__ __forceinline__ float node(const float* a, long long row, int n, int h, int head) {
  return row < n ? a[row * h + head] : 0.f;
}

// The compiled width for f: the smallest FP >= f, or SLAB for wider f.
__host__ __device__ constexpr int width_of(int f) {
  return f <= 4 ? 4 : f <= 8 ? 8 : f <= 16 ? 16 : f <= 32 ? 32 : f <= 40 ? 40 : SLAB;
}

// The kernel compiled for width_of(f).
template <typename Kernel>
Kernel pick_width(int f, Kernel k4, Kernel k8, Kernel k16, Kernel k32, Kernel k40,
                  Kernel k64) {
  return f <= 4 ? k4 : f <= 8 ? k8 : f <= 16 ? k16 : f <= 32 ? k32 : f <= 40 ? k40 : k64;
}

#define GAT_TILE_WIDTHS(kernel, any)                                                     \
  kernel<4, any>, kernel<8, any>, kernel<16, any>, kernel<32, any>, kernel<40, any>, \
      kernel<64, any>

// `kernel` on `grid` with `smem` bytes of dynamic shared memory (above 48 KB
// only after the opt-in), on `stream`; returns the launch's CUDA error. A
// refused opt-in is also the runtime's last error: it is cleared here, or the
// library's next launch would report it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// How many of an item's tiles the item kernels stage at once, given one tile's
// staged bytes: all C while they fit in 48 KB, else fewer (at least one).
inline int tile_group(size_t tile_bytes, int max_tiles) {
  const int fit = static_cast<int>((48 * 1024) / tile_bytes);
  return fit < 1 ? 1 : fit < max_tiles ? fit : max_tiles;
}

// ------------------------------------------------------------------------
// Work items of B3, B5-B9 (the wrapper's spmm_schedule): tiles [begin, end)
// of block row `row`. A row of one item (at most C tiles, or none) has
// slot = -1 and writes its outputs itself; the `parts` items of a longer row
// write partials (B3, B7: m, den, num; B5, B6, B8, B9: their gradients) to
// workspace slots first .. first + parts - 1 (this item to `slot`), and the
// last of them to arrive merges them.
// ------------------------------------------------------------------------

struct Item {
  int begin, end, row, slot, first, parts;
};

__device__ __forceinline__ Item load_item(const int* items) {
  const int* it = items + static_cast<size_t>(blockIdx.x) * ITEM_INTS;
  return Item{it[0], it[1], it[2], it[3], it[4], it[5]};
}

// Decode the masks of an item's (panel) tiles once into mask_sh [C][TM]
// (this thread's own words) and into cols_sh [C] their block columns (the
// fast case) or first column nodes (ANY), as stage_tiles reads them with
// col_unit<ANY>; the caller's first barrier publishes cols_sh.
template <bool ANY>
__device__ __forceinline__ void load_item_tiles(const Geo& g, const Item& it, const void* tiles,
                                                int bf16, const int* block_cols, uint4* mask_sh,
                                                int* cols_sh) {
  const int nt = it.end - it.begin, i = threadIdx.x;
  if constexpr (ANY) {
    if (i < nt) cols_sh[i] = static_cast<int>(first_node<true>(g, block_cols[it.begin + i]));
  } else {
    if (i < nt) cols_sh[i] = block_cols[it.begin + i];
  }
  for (int t = 0; t < nt; ++t) {
    const int bc = ANY ? block_cols[it.begin + t] : 0;
    // read by this thread only
    mask_sh[t * TM + i] = panel_mask<ANY>(g, tiles, bf16, it.begin + t, it.row, bc);
  }
}

// Columns c0 .. c0 + fw - 1 of row `row` of x [n, ld] into W registers, zero
// past n and fw.
template <int W>
__device__ __forceinline__ void load_cols(float dst[W], const float* x, long long row, int n,
                                          int ld, int c0, int fw) {
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k] = (row < n && k < fw) ? __ldg(x + row * ld + c0 + k) : 0.f;
}

// B5's and B5s's walk of one tile's own edges u -> v for receiver v (this
// thread), one head and one F-slab: acc += p (s2_u . dnum_v + dd) leaky'(pre),
// with pre = ld + lsrc_u and p = exp(leaky(pre) - mv); dd is dden_v on the
// first slab and 0 on the others. ls points at the tile's senders' staged
// lsrc of this head (sender j at j * hs), st at their s2 slab
// [TK][slab_stride(FP)]; dn holds dnum_v's slab.
template <int FP>
__device__ __forceinline__ void receiver_walk(uint4 own, const float* ls, int hs, const float* st,
                                              float ld, float mv, const float dn[FP], float dd,
                                              float slope, float& acc) {
  constexpr int S = slab_stride(FP);
  for_own_edges(own, [&](int j) {
    const float pre = ld + ls[j * hs];
    const float p = expf(leaky(pre, slope) - mv);
    const float4* sj = reinterpret_cast<const float4*>(st + j * S);
    float gdot = 0.f;
#pragma unroll
    for (int q = 0; q < FP / 4; ++q) {
      const float4 x = sj[q];
      gdot = fmaf(dn[4 * q + 0], x.x, gdot);
      gdot = fmaf(dn[4 * q + 1], x.y, gdot);
      gdot = fmaf(dn[4 * q + 2], x.z, gdot);
      gdot = fmaf(dn[4 * q + 3], x.w, gdot);
    }
    acc += p * (gdot + dd) * (pre >= 0.f ? 1.f : slope);
  });
}

// B6's and B6s's walk of one tile's own edges u -> v for sender u (this
// thread), one head and one F-slab: ds += p dnum_v and dl += p (s2_u . dnum_v
// + dden_v) leaky'(pre), with pre = lsrc_u + ldst_v and p = exp(leaky(pre) -
// m_v); dden's term only on the first slab. ld, m and dd point at the
// tile's receivers' staged values of this head (receiver j at j * hs), dn at
// their dnum slab [TK][slab_stride(FP)]; su holds s2_u's slab.
template <int FP>
__device__ __forceinline__ void sender_walk(uint4 own, const float* ld, const float* m,
                                            const float* dd, int hs, const float* dn, float lu,
                                            const float su[FP], bool first, float slope,
                                            float ds[FP], float& dl) {
  constexpr int S = slab_stride(FP);
  for_own_edges(own, [&](int j) {
    const int at = j * hs;
    const float pre = lu + ld[at];
    const float p = expf(leaky(pre, slope) - m[at]);
    const float4* dj = reinterpret_cast<const float4*>(dn + j * S);
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
    dl += p * (gdot + (first ? dd[at] : 0.f)) * (pre >= 0.f ? 1.f : slope);
  });
}

// ------------------------------------------------------------------------
// The per-tile ("stream") kernels' merges (B4, B5s, B6s): each tile adds its
// rows into zero-filled outputs with f32 reductions, and B4 takes the row max
// with a float atomic max; the sum order is free.
// ------------------------------------------------------------------------

// Adds W registers into columns 0 .. fw - 1 of `dst`: four at a time
// (red.global.add.v4.f32; `quads`: dst is 16-byte aligned and fw a multiple
// of 4), else one column at a time.
template <int W>
__device__ __forceinline__ void add_cols(float* dst, int fw, const float x[W], bool quads) {
  if (quads) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      if (4 * q < fw)
        atomicAdd(reinterpret_cast<float4*>(dst) + q,
                  make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < fw) atomicAdd(dst + k, x[k]);
  }
}

// *at = max(*at, x) for floats without NaNs: non-negative floats order as
// signed ints, negative ones (-0 included) inversely as unsigned ints.
__device__ __forceinline__ void atomic_max_float(float* at, float x) {
  if (__float_as_int(x) >= 0) {
    atomicMax(reinterpret_cast<int*>(at), __float_as_int(x));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(at), __float_as_uint(x));
  }
}

// The split-row workspace: n_slots partials of num [TM, hf], then of den
// and m [TM, h].
struct Partials {
  float* num;
  float* den;
  float* m;
  __device__ Partials(float* ws, int n_slots, int h, int hf)
      : num(ws),
        den(ws + static_cast<size_t>(n_slots) * TM * hf),
        m(ws + static_cast<size_t>(n_slots) * TM * (hf + h)) {}
};

// Where thread i's row of an item writes head `head`'s F-slab s0 .. s0 + fw
// (and, with s0 = 0, its den and m): the output row v (when v < n) of a row
// of one item, else the item's workspace slot.
template <int FP>
__device__ __forceinline__ void put_softmax(const Item& it, const Partials& ws, float* num_out,
                                            float* den_out, float* m_out, long long v, int n,
                                            int h, int hf, int head, int f, int s0, int fw,
                                            const float acc[FP], float den, float m) {
  float *num_row, *den_at, *m_at;
  if (it.slot < 0) {
    if (v >= n) return;
    num_row = num_out + v * hf;
    den_at = den_out + v * h + head;
    m_at = m_out + v * h + head;
  } else {
    const size_t r = static_cast<size_t>(it.slot) * TM + threadIdx.x;
    num_row = ws.num + r * hf;
    den_at = ws.den + r * h + head;
    m_at = ws.m + r * h + head;
  }
  float* dst = num_row + static_cast<long long>(head) * f + s0;
#pragma unroll
  for (int k = 0; k < FP; ++k)
    if (k < fw) dst[k] = acc[k];
  if (s0 == 0) {
    *den_at = den;
    *m_at = m;
  }
}

// After an item of a split row has written its partials: true in the CTA
// that arrives last at its row's counter (which it resets for the next
// launch), with every part's partials then visible to it.
__device__ __forceinline__ bool arrive_last(int* counter, int parts) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(counter, 1) + 1;
    last = arrived == parts;
    if (arrived == parts) *counter = 0;  // every part has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// The flash merge of a split row's parts, in item order, into its output
// rows: m = max_i m_i, den = sum_i s_i den_i and num = sum_i s_i num_i with
// s_i = exp(m_i - m), and s_i = 0 for a part still at NEG (it has no edge and
// zero sums; exp(NEG - NEG) = 1 must not leak in). The scales overwrite the
// parts' m in the workspace, which only this CTA reads now. The same bits
// whichever part arrives last. The parts come from L2, so each thread keeps
// several independent loads in flight: four parts at a time, and num in
// 16-byte quads when F is a multiple of 4 (a quad then lies in one head).
template <bool ANY>
__device__ __forceinline__ void merge_parts(const Geo& g, const Item& it, const Partials& ws,
                                            float* num_out, float* den_out, float* m_out, int n,
                                            int h, int hf) {
  const long long row0 = first_node<ANY>(g, it.row);
  const long long left = static_cast<long long>(n) - row0;
  const int extent = panel_extent<ANY>(g, it.row);
  const int rows = left < extent ? static_cast<int>(left) : extent;
  const size_t m_part = static_cast<size_t>(TM) * h, num_part = static_cast<size_t>(TM) * hf;
  const size_t base = static_cast<size_t>(it.first) * TM;
  const int parts = it.parts;
  for (int idx = threadIdx.x; idx < rows * h; idx += THREADS) {
    const int r = idx / h, head = idx % h;
    const size_t at = (base + r) * h + head;
    float m = NEG;
#pragma unroll 4
    for (int p = 0; p < parts; ++p) m = fmaxf(m, __ldcg(ws.m + at + p * m_part));
    float den = 0.f;
#pragma unroll 4
    for (int p = 0; p < parts; ++p) {
      const float mp = __ldcg(ws.m + at + p * m_part);
      const float s = mp == NEG ? 0.f : expf(mp - m);
      __stcg(ws.m + at + p * m_part, s);
      den = fmaf(s, __ldcg(ws.den + at + p * m_part), den);
    }
    den_out[(row0 + r) * h + head] = den;
    m_out[(row0 + r) * h + head] = m;
  }
  __syncthreads();  // the scales are in place
  const int f = hf / h;
  if (f % 4 == 0) {
    const int quads = hf / 4;
    for (int idx = threadIdx.x; idx < rows * quads; idx += THREADS) {
      const int r = idx / quads, c = (idx % quads) * 4;
      const float* num_at = ws.num + (base + r) * hf + c;
      const float* s_at = ws.m + (base + r) * h + c / f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int p = 0; p < parts; ++p) {
        const float s = __ldcg(s_at + p * m_part);
        const float4 v = __ldcg(reinterpret_cast<const float4*>(num_at + p * num_part));
        acc.x = fmaf(s, v.x, acc.x);
        acc.y = fmaf(s, v.y, acc.y);
        acc.z = fmaf(s, v.z, acc.z);
        acc.w = fmaf(s, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(num_out + (row0 + r) * hf + c) = acc;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * hf; idx += THREADS) {
      const int r = idx / hf, c = idx % hf;
      const float* num_at = ws.num + (base + r) * hf + c;
      const float* s_at = ws.m + (base + r) * h + c / f;
      float acc = 0.f;
#pragma unroll 4
      for (int p = 0; p < parts; ++p)
        acc = fmaf(__ldcg(s_at + p * m_part), __ldcg(num_at + p * num_part), acc);
      num_out[(row0 + r) * hf + c] = acc;
    }
  }
}

// ------------------------------------------------------------------------
// The split rows of the backward kernels (B5, B6, B8, B9): each item writes
// its rows' gradients, a row of one item into the outputs, the items of a
// longer row into their workspace slots [n_slots][TM][width], and the last
// to arrive adds the parts in item order (sum_parts).
// ------------------------------------------------------------------------

// Where thread i's row of an item writes an output `out` [n, ld]: row v of
// it (nullptr past n) for a row of one item, else the item's workspace slot
// row, from column `col` (an output's place in the part).
__device__ __forceinline__ float* grad_row(const Item& it, float* ws, int width, int col,
                                           float* out, int ld, long long v, int n) {
  if (it.slot >= 0) return ws + (static_cast<size_t>(it.slot) * TM + threadIdx.x) * width + col;
  return v < n ? out + v * ld : nullptr;
}

// Columns c0 .. c0 + fw - 1 of a row: written from, or read back into, W
// registers (zero past fw, or for a row that is not written).
template <int W>
__device__ __forceinline__ void put_cols(float* row, int c0, int fw, const float x[W]) {
  if (row == nullptr) return;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < fw) row[c0 + k] = x[k];
}
template <int W>
__device__ __forceinline__ void get_cols(float x[W], const float* row, int c0, int fw) {
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = (row != nullptr && k < fw) ? row[c0 + k] : 0.f;
}

// After the items of a split row have written their gradient partials: the
// sum of the parts, in item order, into the row's outputs: columns 0 .. hf
// of a part into out0 [n, hf], the rest (width - hf, none when out1 is
// null) into out1 [n, width - hf]. The same bits whichever part arrives
// last. Four parts at a time and 16-byte quads when both outputs' widths are
// multiples of 4 (a quad then lies in one output), as merge_parts.
template <bool ANY>
__device__ __forceinline__ void sum_parts(const Geo& g, const Item& it, const float* ws,
                                          int width, float* out0, float* out1, int n, int hf) {
  const long long row0 = first_node<ANY>(g, it.row);
  const long long left = static_cast<long long>(n) - row0;
  const int extent = panel_extent<ANY>(g, it.row);
  const int rows = left < extent ? static_cast<int>(left) : extent;
  const int w1 = width - hf;
  const size_t part = static_cast<size_t>(TM) * width;
  const float* base = ws + static_cast<size_t>(it.first) * part;
  const int parts = it.parts;
  if (hf % 4 == 0 && w1 % 4 == 0) {
    const int quads = width / 4;
    for (int idx = threadIdx.x; idx < rows * quads; idx += THREADS) {
      const int r = idx / quads, c = (idx % quads) * 4;
      const float* at = base + static_cast<size_t>(r) * width + c;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int p = 0; p < parts; ++p) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(at + p * part));
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      float* out = c < hf ? out0 + (row0 + r) * hf + c : out1 + (row0 + r) * w1 + (c - hf);
      *reinterpret_cast<float4*>(out) = acc;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += THREADS) {
      const int r = idx / width, c = idx % width;
      const float* at = base + static_cast<size_t>(r) * width + c;
      float acc = 0.f;
#pragma unroll 4
      for (int p = 0; p < parts; ++p) acc += __ldcg(at + p * part);
      if (c < hf) {
        out0[(row0 + r) * hf + c] = acc;
      } else {
        out1[(row0 + r) * w1 + c - hf] = acc;
      }
    }
  }
}

}  // namespace gat_tile
