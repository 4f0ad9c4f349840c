// What the GAT tile-attention kernels share (gat_tile_attn.cu: B3/B5/B6,
// gatv2_tile_attn.cu: B7/B8/B9): the tile shape, the mask read by warp
// ballots, the warp-uniform walk over a tile's needed columns, operand
// staging, and the per-width kernel pick.
//
// The mask is never stored: warp w reads rows 32w..32w+31 of a tile, one
// 16-byte (f32) or 8-byte (bf16) load a lane per row, and four ballots give
// that row's 128 mask bits (bit l of word c is column 4l + c), which lane r
// keeps for its own row. The warp then walks the columns that any of its 32
// rows needs (the OR of its words) and evaluates every (row, column) slot
// there; a kernel applies the mask by select, never by multiplying.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace gat_tile {

constexpr int TM = 128;  // tile rows
constexpr int TK = 128;  // tile columns
constexpr int THREADS = 128;  // one thread per tile row
constexpr int MAX_F = 64;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == TM, "one thread per tile row");

__device__ __forceinline__ float leaky(float x, float slope) { return x >= 0.f ? x : slope * x; }

// The four mask words of this thread's row of `tile`: bit l of word c is set
// when tile[row][4l + c] != 0 (-0 counts as zero, as in the plain version).
__device__ __forceinline__ void mask_words(const void* tile, bool bf16, uint32_t w[4]) {
  const int lane = threadIdx.x & 31;
  const int row0 = threadIdx.x & ~31;
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const size_t row = static_cast<size_t>(row0 + r) * TK;
    bool nz0, nz1, nz2, nz3;
    if (bf16) {
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

// Calls body(j, on) for every column j of the tile that some row of the warp
// needs; `on` says whether this thread's row has an edge there. The loop is
// uniform across the warp.
template <typename Body>
__device__ __forceinline__ void for_columns(const uint32_t w[4], Body body) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t any = __reduce_or_sync(FULL, w[c]);
    while (any) {
      const int l = __ffs(any) - 1;
      any &= any - 1;
      body(4 * l + c, (w[c] >> l) & 1u);
    }
  }
}

// Stage rows col0 .. col0 + TK - 1 of the head's F columns of x [n, H*F] into
// xs [TK][FP], zero past n and past F.
template <int FP>
__device__ __forceinline__ void stage_feats(float* xs, const float* x, long long col0, int n,
                                            int hf, int head, int f) {
  for (int i = threadIdx.x; i < TK * FP; i += THREADS) {
    const int j = i / FP, k = i % FP;
    const long long row = col0 + j;
    xs[i] = (row < n && k < f) ? x[row * hf + static_cast<long long>(head) * f + k] : 0.f;
  }
}

__device__ __forceinline__ float node(const float* a, long long row, int n, int h, int head) {
  return row < n ? a[row * h + head] : 0.f;
}

// The kernel compiled for the smallest width FP >= f.
template <typename Kernel>
Kernel pick_width(int f, Kernel k4, Kernel k8, Kernel k16, Kernel k32, Kernel k40,
                  Kernel k64) {
  return f <= 4 ? k4 : f <= 8 ? k8 : f <= 16 ? k16 : f <= 32 ? k32 : f <= 40 ? k40 : k64;
}

#define GAT_TILE_WIDTHS(kernel) \
  kernel<4>, kernel<8>, kernel<16>, kernel<32>, kernel<40>, kernel<64>

inline dim3 grid_of(int n_block_rows, int h) {
  return dim3(static_cast<unsigned>(n_block_rows) * h);
}

}  // namespace gat_tile
