// Kernels B1 and B2 for Hopper (sm_90a): block-sparse SpMM over BCSR tiles.
//
//   B1: y[:n_rows, :h] = sum over tiles t of  data[t] @ x[bc[t]*TK : +TK, :]
//                        added into block row br[t]
//   B2: part[t] = data[t] @ x[bc[t]*TK : +TK, :], one [TM, h] block per tile
//       (the caller sums the parts into their block rows)
//
// Replaces the TPU kernel pygcn_tpu/ops/pallas/bcsr_spmm.py:_kernel, whose
// grid runs the tiles in order on one core and carries each block row's sum
// in the revisited output block. Here one CTA owns one (block row, slab of
// BN output columns) and loops over that row's tiles
// (block_row_ptr[r] .. block_row_ptr[r+1]) itself: the sum lives in
// registers, the output is written once, there are no atomics, and the result
// is deterministic. A block row with no tiles writes zeros.
//
// Bound on an H100 SXM: for the ogbn-arxiv-sized hybrid (2863 tiles, H = 128,
// f32) the function must read the tiles as stored (~0.19 GB) and x (~0.09 GB)
// and write the output (~0.09 GB): ~0.11 ms at 3.35 TB/s. The tiles are only
// ~7% full (~3.1M nonzeros), so the products it needs, 2*nnz*H = ~0.8 GFLOP,
// take ~0.01 ms at the 67 TFLOP/s f32 rate outside the tensor cores: the
// function is bound by bytes. This kernel multiplies whole tiles instead,
// 2*T*128*128*H = ~12 GFLOP, ~0.18 ms of FFMA at that rate, so its dense
// products and not its bytes keep it above the bound. The design keeps the
// FMA pipes fed: each thread holds an 8x4 register tile, every inner step
// issues three 16-byte shared loads for 32 FMAs, and the k-chunks of the row's
// tiles run as one stream through a double-buffered shared stage: the next
// chunk's 16-byte global loads are in flight in registers while the current
// chunk's FMAs run, with one barrier per chunk and two CTAs per SM. Skipping
// zeros, tensor cores (wgmma) and TMA staging are left to later work.
//
// bf16 tiles: x is rounded to bf16 first (round to nearest even, as the JAX
// kernel's astype does) and the sum is kept in f32; the bf16 x bf16 products
// are exact in f32, so only the input rounding differs from the f32 path.
//
// B2 (replaces pygcn_tpu/ops/pallas/bcsr_spmm.py:_kernel_stream, the
// BCSR_STREAM mode) is the same kernel with STREAM set: one CTA owns one
// (tile, slab of BN output columns), takes that tile's k-chunks only, and
// writes all TM rows of the tile's part. A launch then has one CTA per tile
// instead of one per block row, so no block row with many tiles sets its
// tail, but it writes T x TM x h parts (~0.19 GB at the arxiv shapes) that a
// merge reads back. Bound at those shapes: the tiles, the x rows under them
// and the parts, ~0.46 GB, ~0.14 ms at 3.35 TB/s.
//
// Ragged shapes are masked in the kernel: rows of x past n_cols read as zero,
// output rows past n_rows and columns past h are not written, so neither x nor
// the output is padded by a copy. x and the output take 16-byte accesses when
// h is a multiple of 4 and x is 16-byte aligned, element accesses otherwise.
// Tiles must be 16-byte (f32) or 8-byte (bf16) aligned; the wrapper checks.
// Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TM = 128;   // tile rows (output rows of a block row)
constexpr int TK = 128;   // tile columns (x rows per tile)
constexpr int BN = 64;    // output columns per CTA
constexpr int BK = 16;    // k-chunk staged in shared memory
constexpr int THREADS = 256;
constexpr int RM = 8;     // output rows per thread
constexpr int RN = 4;     // output columns per thread
constexpr int AS_STRIDE = TM + 4;  // keeps float4 reads aligned, cuts store conflicts to 2-way
constexpr int CHUNKS_PER_TILE = TK / BK;
constexpr int A_VECS = TM * BK / 4 / THREADS;  // 4-value tile loads per thread per chunk
constexpr int B_VECS = BK * BN / 4 / THREADS;  // 4-value x loads per thread per chunk

static_assert((TM / RM) * (BN / RN) == THREADS, "thread tiling must cover the CTA tile");
static_assert(A_VECS * 4 * THREADS == TM * BK && B_VECS * 4 * THREADS == BK * BN,
              "staging must divide evenly");

__device__ __forceinline__ float4 load_tile4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_tile4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float x_value(float v, const float*) { return v; }
__device__ __forceinline__ float x_value(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// STREAM (B2): blockIdx.x is a tile, block_row_ptr is not read, and out is
// the parts [T * TM, h] (n_rows = T * TM).
template <typename T, bool VEC, bool STREAM>
__global__ void __launch_bounds__(THREADS, 2)
bcsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ block_cols,
                 const int* __restrict__ block_row_ptr, const float* __restrict__ x,
                 float* __restrict__ out, int n_rows, int n_cols, int h) {
  __shared__ __align__(16) float As[2][BK][AS_STRIDE];  // As[b][k][r] = tile[r][k0 + k]
  __shared__ __align__(16) float Bs[2][BK][BN];         // Bs[b][k][c] = x[col0 + k0 + k][n0 + c]

  const int br = blockIdx.x;  // block row of the output, or (STREAM) the tile
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / RN);
  const int ty = tid / (BN / RN);

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int t_begin = STREAM ? br : block_row_ptr[br];
  const int n_chunks =
      STREAM ? CHUNKS_PER_TILE : (block_row_ptr[br + 1] - t_begin) * CHUNKS_PER_TILE;

  float4 ra[A_VECS];
  float4 rb[B_VECS];

  // Global -> registers for chunk c (tile t_begin + c / CHUNKS_PER_TILE).
  auto load = [&](int c) {
    const int t = t_begin + c / CHUNKS_PER_TILE;
    const int k0 = (c % CHUNKS_PER_TILE) * BK;
    const T* tile = data + static_cast<size_t>(t) * TM * TK;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 4), kq = idx % (BK / 4);
      ra[i] = load_tile4(tile + static_cast<size_t>(r) * TK + k0 + kq * 4);
    }
    const long long row0 = static_cast<long long>(block_cols[t]) * TK + k0;
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / (BN / 4), col = n0 + (idx % (BN / 4)) * 4;
      const long long row = row0 + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_cols) {
        const float* src = x + row * h + col;
        if constexpr (VEC) {
          if (col < h) v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (col < h) v.x = __ldg(src);
          if (col + 1 < h) v.y = __ldg(src + 1);
          if (col + 2 < h) v.z = __ldg(src + 2);
          if (col + 3 < h) v.w = __ldg(src + 3);
        }
      }
      rb[i] = make_float4(x_value(v.x, data), x_value(v.y, data), x_value(v.z, data),
                          x_value(v.w, data));
    }
  };

  // Registers -> shared buffer b (tile chunk transposed to k-major).
  auto store = [&](int b) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 4), k = (idx % (BK / 4)) * 4;
      As[b][k + 0][r] = ra[i].x;
      As[b][k + 1][r] = ra[i].y;
      As[b][k + 2][r] = ra[i].z;
      As[b][k + 3][r] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<float4*>(&Bs[b][idx / (BN / 4)][(idx % (BN / 4)) * 4]) = rb[i];
    }
  };

  if (n_chunks > 0) {
    load(0);
    store(0);
    __syncthreads();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    const bool more = c + 1 < n_chunks;
    if (more) load(c + 1);  // in flight while this chunk's FMAs run
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[b][k][ty * RM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[b][k][ty * RM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[b][k][tx * RN]);
      const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[RN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    // Buffer b ^ 1 was last read in iteration c - 1, before its barrier.
    if (more) store(b ^ 1);
    __syncthreads();
  }

  const int col = n0 + tx * RN;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long row = static_cast<long long>(br) * TM + ty * RM + i;
    if (row >= n_rows) break;
    float* dst = out + row * h + col;
    if constexpr (VEC) {
      if (col < h) *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (col + j < h) dst[j] = acc[i][j];
    }
  }
}

// grid_rows CTAs down: block rows (B1) or tiles (B2, STREAM).
template <typename T, bool STREAM>
int launch(const void* data, const void* block_cols, const void* block_row_ptr,
           const void* x, void* out, int grid_rows, int n_rows, int n_cols, int h,
           void* stream) {
  const dim3 grid(grid_rows, (h + BN - 1) / BN);
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  void (*kernel)(const T*, const int*, const int*, const float*, float*, int, int, int) =
      vec ? bcsr_spmm_kernel<T, true, STREAM> : bcsr_spmm_kernel<T, false, STREAM>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(block_cols),
      static_cast<const int*>(block_row_ptr), static_cast<const float*>(x),
      static_cast<float*>(out), n_rows, n_cols, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile shape the kernel is compiled for; the Python wrapper checks it.
int bcsr_spmm_tile(int* tm, int* tk) {
  *tm = TM;
  *tk = TK;
  return 0;
}

// B1. f32 tiles, f32 x -> f32 out. Returns cudaGetLastError() after the launch.
int bcsr_spmm_f32(const void* data, const void* block_cols, const void* block_row_ptr,
                  const void* x, void* out, int n_block_rows, int n_rows, int n_cols,
                  int h, void* stream) {
  return launch<float, false>(data, block_cols, block_row_ptr, x, out, n_block_rows, n_rows,
                              n_cols, h, stream);
}

// B1. bf16 tiles, f32 x (rounded to bf16 in the kernel) -> f32 out.
int bcsr_spmm_bf16(const void* data, const void* block_cols, const void* block_row_ptr,
                   const void* x, void* out, int n_block_rows, int n_rows, int n_cols,
                   int h, void* stream) {
  return launch<__nv_bfloat16, false>(data, block_cols, block_row_ptr, x, out, n_block_rows,
                                      n_rows, n_cols, h, stream);
}

// B2. f32 tiles, f32 x -> f32 parts [n_tiles * TM, h].
int bcsr_spmm_stream_f32(const void* data, const void* block_cols, const void* x, void* parts,
                         int n_tiles, int n_cols, int h, void* stream) {
  return launch<float, true>(data, block_cols, nullptr, x, parts, n_tiles, n_tiles * TM,
                             n_cols, h, stream);
}

// B2. bf16 tiles, f32 x (rounded to bf16 in the kernel) -> f32 parts.
int bcsr_spmm_stream_bf16(const void* data, const void* block_cols, const void* x, void* parts,
                          int n_tiles, int n_cols, int h, void* stream) {
  return launch<__nv_bfloat16, true>(data, block_cols, nullptr, x, parts, n_tiles,
                                     n_tiles * TM, n_cols, h, stream);
}

}  // extern "C"
