// Kernels B1 and B2 for Hopper (sm_90a): block-sparse SpMM over BCSR tiles,
//
//   y[:n_rows, :h] = sum over tiles t of  data[t] @ x[bc[t]*TK : +TK, :]
//                    added into block row br[t].
//
// B1 replaces the TPU kernel pygcn_tpu/ops/pallas/bcsr_spmm.py:_kernel, whose
// grid runs the tiles in order on one core and carries each block row's sum
// in the revisited output block. B2 replaces _kernel_stream (the BCSR_STREAM
// mode) together with the segment_sum that merges its per-tile parts.
//
// Bound on an H100 SXM, at the ogbn-arxiv hybrid's shapes (2863 f32 tiles,
// H = 128): the function reads the tiles as stored (0.19 GB) and the x rows
// under them (0.09 GB) and writes y (0.09 GB), 0.108 ms at 3.35 TB/s. The
// tiles are only 7% full, so the 2*nnz*H products it needs take 0.01 ms: it is
// bound by bytes. A kernel that multiplies whole tiles does 2*T*128*128*H =
// 12 GFLOP, 0.18 ms of FFMA outside the tensor cores, so the products run on
// the tensor cores instead:
//
// - 3xTF32. Each f32 operand v is split into hi = v rounded to TF32 and
//   lo = v - hi rounded to TF32 (both as cvt.rna.tf32 rounds, see to_tf32),
//   and mma.sync m16n8k8 TF32 accumulates a_lo*x_hi + a_hi*x_lo + a_hi*x_hi
//   in f32 registers: the error stays near f32's (one TF32 product alone
//   keeps about three digits). 36 GFLOP, 0.073 ms at the 495 TFLOP/s dense
//   TF32 rate, which only wgmma reaches. bf16 tiles take one m16n8k16 bf16 MMA: x is
//   rounded to bf16 (round to nearest even, as the JAX kernel's astype does)
//   as its fragment is built, and the bf16 x bf16 products are exact in f32.
// - Each tile is read once: one CTA covers up to 128 output columns (a 64-wide
//   variant for H <= 64), and its 8 warps walk the columns in 8-wide MMA steps
//   up to H, not to a fixed slab width.
// - Staging: a ring of STAGES k-chunks (the tile's 128 x BK slice and the
//   BK x BN x rows under it) in dynamic shared memory, filled by 16-byte
//   cp.async.cg; rows are padded so fragment loads hit 32 distinct banks. x
//   rows past n_cols and columns past h arrive as zeros through cp.async's
//   src-size operand, so x is never read past its end or padded by a copy.
//
// B1's schedule (built by the wrapper once per tile set): each block row's
// tile run is cut into work items of at most C consecutive tiles, one CTA per
// item, so no block row with many tiles sets the launch's tail (the
// flagship's longest has 43, the mean 2.16). A row with at most C tiles is one
// item and writes its output block once, with no atomics; a row without tiles
// is an item that writes zeros. The items of a longer row write partial blocks
// to a workspace, fence, and count their arrival on the row's counter; the
// CTA that arrives last sums the partials in item order, writes y and resets
// the counter for the next launch. One launch, and the same bits every run.
//
// B2 keeps the per-tile grid of the JAX flag: one CTA per tile adds its
// [128, H] product into y (zero-filled by the wrapper) with sm_90's four-wide
// f32 reduction (atomicAdd on float4, RED.ADD.F32x4), scalar on ragged
// columns. No parts array and no separate merge; the order of the sums, and
// so the last bits, vary from run to run.
//
// Ragged shapes: output rows past n_rows and columns past h are not written.
// x, y and the workspace take 16-byte accesses when h is a multiple of 4 and
// they are 16-byte aligned, element accesses otherwise. Tiles must be 16-byte
// aligned; the wrapper checks. Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int TM = 128;  // tile rows (output rows of a block row)
constexpr int TK = 128;  // tile columns (x rows per tile)
constexpr int BK = 32;   // tile columns per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS_PER_TILE = TK / BK;
constexpr int ITEM_INTS = 6;  // begin, end, block row, slot, first slot, parts

// WN warps across the columns: BN = 64 * WN output columns per CTA, each warp
// MT 16-row by NT 8-column MMA tiles (64 columns).
template <typename T, int WN>
struct Shape {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BN = 64 * WN;
  static constexpr int WM = WARPS / WN;
  static constexpr int MT = TM / WM / 16;
  static constexpr int NT = 8;
  // Row strides: tf32 A fragments read rows 4 words apart, bf16 ones 20; x
  // fragments read rows 8 (tf32) or 4 (bf16, two rows per register) apart.
  static constexpr int A_STRIDE = BF16 ? BK + 8 : BK + 4;  // elements of T
  static constexpr int X_STRIDE = BN + (BF16 ? 4 : 8);     // floats
  static constexpr int A_STAGE = TM * A_STRIDE;
  static constexpr int X_STAGE = BK * X_STRIDE;
  static constexpr int A_BYTES = STAGES * A_STAGE * static_cast<int>(sizeof(T));
  static constexpr int SMEM = A_BYTES + STAGES * X_STAGE * 4;
  static_assert(MT * 16 * WM == TM, "warps must cover the tile rows");
  static_assert((A_STRIDE * sizeof(T)) % 16 == 0 && (X_STRIDE * 4) % 16 == 0,
                "staged rows must stay 16-byte aligned");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, for finite v), in two integer ops. The f32 path splits 24 values
// per 48 MMAs; with the conversion instruction instead, B1 ran 10-13%
// slower on an H100 (apps/time_spmm.py, both versions in turns in one run).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive columns [col, col + 4) of one row: store, or (ADD) reduce
// into dst. VEC: one 16-byte access (h % 4 == 0, so all four are in range).
template <bool VEC, bool ADD>
__device__ __forceinline__ void put4(float* dst, float4 v, int col, int h) {
  if constexpr (VEC) {
    if constexpr (ADD) {
      atomicAdd(reinterpret_cast<float4*>(dst), v);
    } else {
      *reinterpret_cast<float4*>(dst) = v;
    }
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col + j < h) {
        if constexpr (ADD) {
          atomicAdd(dst + j, a[j]);
        } else {
          dst[j] = a[j];
        }
      }
    }
  }
}

// STREAM (B2): blockIdx.x is a tile; items, ws and counters are not read.
// Otherwise (B1) blockIdx.x is a work item of the schedule (ITEM_INTS ints:
// tiles [begin, end) of block row `row`; `slot` -1 for a row of one item, else
// this item's partial in ws, whose row's partials are slots first .. first +
// parts - 1 and whose arrival counter is counters[blockIdx.y * n_slots + first]).
template <typename T, int WN, bool VEC, bool STREAM>
__global__ void __launch_bounds__(THREADS, 2)
bcsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ block_rows,
                 const int* __restrict__ block_cols, const int* __restrict__ items,
                 const float* __restrict__ x, float* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ counters, int n_slots, int n_rows, int n_cols, int h) {
  using S = Shape<T, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const As = reinterpret_cast<T*>(smem);
  float* const Xs = reinterpret_cast<float*>(smem + S::A_BYTES);
  __shared__ int last_arrival;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int n0 = blockIdx.y * S::BN;
  const int wcol = n0 + wn * 64;  // first output column of this warp

  int begin, end, row, slot = -1, first = 0, parts = 1;
  if constexpr (STREAM) {
    begin = blockIdx.x;
    end = begin + 1;
    row = block_rows[begin];
  } else {
    const int* it = items + static_cast<size_t>(blockIdx.x) * ITEM_INTS;
    begin = it[0];
    end = it[1];
    row = it[2];
    slot = it[3];
    first = it[4];
    parts = it[5];
  }
  const int n_chunks = (end - begin) * CHUNKS_PER_TILE;

  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // Chunk c (tile begin + c / CHUNKS_PER_TILE, tile columns k0 .. k0 + BK)
  // into ring stage `stage`.
  auto load = [&](int c, int stage) {
    const int tile = begin + c / CHUNKS_PER_TILE;
    const int k0 = (c % CHUNKS_PER_TILE) * BK;
    const T* src = data + static_cast<size_t>(tile) * TM * TK + k0;
    T* a_dst = As + stage * S::A_STAGE;
    constexpr int A_SEG = 16 / static_cast<int>(sizeof(T));  // elements per copy
    constexpr int A_ROW_SEGS = BK / A_SEG;
#pragma unroll
    for (int i = 0; i < TM * A_ROW_SEGS / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / A_ROW_SEGS, e = (idx % A_ROW_SEGS) * A_SEG;
      cp_async16(a_dst + r * S::A_STRIDE + e, src + r * TK + e, true);
    }
    const long long x_row0 = static_cast<long long>(block_cols[tile]) * TK + k0;
    float* x_dst = Xs + stage * S::X_STAGE;
    if constexpr (VEC) {
      constexpr int ROW_SEGS = S::BN / 4;
#pragma unroll
      for (int i = 0; i < BK * ROW_SEGS / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / ROW_SEGS, e = (idx % ROW_SEGS) * 4;
        const long long xr = x_row0 + k;
        const bool ok = xr < n_cols && n0 + e < h;
        cp_async16(x_dst + k * S::X_STRIDE + e, ok ? x + xr * h + n0 + e : x, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * S::BN / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / S::BN, e = idx % S::BN;
        const long long xr = x_row0 + k;
        const bool ok = xr < n_cols && n0 + e < h;
        cp_async4(x_dst + k * S::X_STRIDE + e, ok ? x + xr * h + n0 + e : x, ok);
      }
    }
  };

  auto compute = [&](int stage) {
    const T* a_s = As + stage * S::A_STAGE;
    const float* x_s = Xs + stage * S::X_STAGE;
    if constexpr (S::BF16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[S::MT][4];
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) {
          const T* p = a_s + ((wm * S::MT + mt) * 16 + g) * S::A_STRIDE + kk + 2 * t4;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * S::A_STRIDE);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * S::A_STRIDE + 8);
        }
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) {
          if (wcol + nt * 8 >= h) continue;  // the same in the whole warp
          const float* q = x_s + (kk + 2 * t4) * S::X_STRIDE + wn * 64 + nt * 8 + g;
          const uint32_t b0 = bf16x2(q[0], q[S::X_STRIDE]);
          const uint32_t b1 = bf16x2(q[8 * S::X_STRIDE], q[9 * S::X_STRIDE]);
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[S::MT][4], al[S::MT][4];
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) {
          const float* p = a_s + ((wm * S::MT + mt) * 16 + g) * S::A_STRIDE + kk + t4;
          const float v[4] = {p[0], p[8 * S::A_STRIDE], p[4], p[8 * S::A_STRIDE + 4]};
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(v[j], ah[mt][j], al[mt][j]);
        }
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) {
          if (wcol + nt * 8 >= h) continue;  // the same in the whole warp
          const float* q = x_s + (kk + t4) * S::X_STRIDE + wn * 64 + nt * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(q[0], bh0, bl0);
          split_tf32(q[4 * S::X_STRIDE], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt) {
            mma_tf32(acc[mt][nt], al[mt], bh0, bh1);  // small terms first
            mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
    }
  };

  // The ring: STAGES - 1 chunks in flight while one is multiplied. Every
  // iteration commits one group (empty past the end) so that wait_group
  // STAGES - 2 always means "chunk c has landed".
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c visible to all; stage (c - 1) % STAGES free
    if (c + STAGES - 1 < n_chunks) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    compute(c % STAGES);
  }

  // Epilogue. An m16n8 accumulator holds rows g and g + 8, columns 2*t4 and
  // 2*t4 + 1; lanes t4 and t4 ^ 1 swap halves so that each holds four
  // consecutive columns of one row: row g + 8*(t4 & 1), columns 4*(t4 >> 1)..+3.
  const bool odd = t4 & 1;
  auto emit = [&](auto&& put) {
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        if (wcol + nt * 8 >= h) continue;  // the same in the whole warp
        const float* c = acc[mt][nt];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        const float4 v = odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
        const int col = wcol + nt * 8 + (t4 >> 1) * 4;
        if (col < h) put((wm * S::MT + mt) * 16 + g + (odd ? 8 : 0), col, v);
      }
  };

  if constexpr (STREAM) {
    emit([&](int r, int col, float4 v) {
      const long long yr = static_cast<long long>(row) * TM + r;
      if (yr < n_rows) put4<VEC, true>(out + yr * h + col, v, col, h);
    });
    return;
  } else {
    if (slot < 0) {
      emit([&](int r, int col, float4 v) {
        const long long yr = static_cast<long long>(row) * TM + r;
        if (yr < n_rows) put4<VEC, false>(out + yr * h + col, v, col, h);
      });
      return;
    }
    emit([&](int r, int col, float4 v) {
      put4<VEC, false>(ws + (static_cast<long long>(slot) * TM + r) * h + col, v, col, h);
    });
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counter = counters + static_cast<size_t>(blockIdx.y) * n_slots + first;
      const int arrived = atomicAdd(counter, 1) + 1;
      last_arrival = arrived == parts;
      if (arrived == parts) *counter = 0;  // every part has arrived: ready for the next launch
    }
    __syncthreads();
    if (!last_arrival) return;
    __threadfence();
    // The last CTA of the row sums its partials in item order: the same bits
    // whichever CTA arrives last.
    const int cols = min(S::BN, h - n0);
    const long long rows_left = static_cast<long long>(n_rows) - static_cast<long long>(row) * TM;
    const int rows = rows_left < TM ? static_cast<int>(rows_left) : TM;  // <= 0: none
    const float* base = ws + static_cast<long long>(first) * TM * h + n0;
    const long long part_stride = static_cast<long long>(TM) * h;
    float* dst = out + static_cast<long long>(row) * TM * h + n0;
    if constexpr (VEC) {
      const int quads = cols / 4;
      for (int idx = tid; idx < rows * quads; idx += THREADS) {
        const long long off = static_cast<long long>(idx / quads) * h + (idx % quads) * 4;
        float4 s = __ldcg(reinterpret_cast<const float4*>(base + off));
        for (int p = 1; p < parts; ++p) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(base + p * part_stride + off));
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        *reinterpret_cast<float4*>(dst + off) = s;
      }
    } else {
      for (int idx = tid; idx < rows * cols; idx += THREADS) {
        const long long off = static_cast<long long>(idx / cols) * h + idx % cols;
        float s = __ldcg(base + off);
        for (int p = 1; p < parts; ++p) s += __ldcg(base + p * part_stride + off);
        dst[off] = s;
      }
    }
  }
}

template <typename T, int WN, bool VEC, bool STREAM>
int launch_one(const void* data, const void* block_rows, const void* block_cols,
               const void* items, const void* x, void* out, void* ws, void* counters,
               int grid_x, int n_slots, int n_rows, int n_cols, int h, void* stream) {
  using S = Shape<T, WN>;
  auto kernel = bcsr_spmm_kernel<T, WN, VEC, STREAM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, (h + S::BN - 1) / S::BN);
  kernel<<<grid, THREADS, S::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(block_rows),
      static_cast<const int*>(block_cols), static_cast<const int*>(items),
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), n_slots, n_rows, n_cols, h);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// grid_x CTAs down: work items (B1) or tiles (B2, STREAM). The 64-column
// variant serves H <= 64; wider H takes 128-column CTAs.
template <typename T, bool STREAM>
int launch(const void* data, const void* block_rows, const void* block_cols, const void* items,
           const void* x, void* out, void* ws, void* counters, int grid_x, int n_slots,
           int n_rows, int n_cols, int h, void* stream) {
  const bool vec = h % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(ws);
  auto go = [&](auto fn) {
    return fn(data, block_rows, block_cols, items, x, out, ws, counters, grid_x, n_slots, n_rows,
              n_cols, h, stream);
  };
  if (h > 64) {
    return vec ? go(launch_one<T, 2, true, STREAM>) : go(launch_one<T, 2, false, STREAM>);
  }
  return vec ? go(launch_one<T, 1, true, STREAM>) : go(launch_one<T, 1, false, STREAM>);
}

}  // namespace

extern "C" {

// Tile shape and work-item width the kernels are compiled for; the Python
// wrapper checks them.
int bcsr_spmm_tile(int* tm, int* tk, int* item_ints) {
  *tm = TM;
  *tk = TK;
  *item_ints = ITEM_INTS;
  return 0;
}

// B1. f32 tiles, f32 x -> f32 out [n_rows, h]. items: the schedule
// [n_items, ITEM_INTS]; ws: n_slots partial blocks [n_slots, TM, h] (null when
// n_slots is 0); counters: n_slots * ceil(h / BN) ints, zero between launches.
// Returns the CUDA error of the launch (0 on success).
int bcsr_spmm_f32(const void* data, const void* block_cols, const void* items, const void* x,
                  void* out, void* ws, void* counters, int n_items, int n_slots, int n_rows,
                  int n_cols, int h, void* stream) {
  return launch<float, false>(data, nullptr, block_cols, items, x, out, ws, counters, n_items,
                              n_slots, n_rows, n_cols, h, stream);
}

// B1. bf16 tiles, f32 x (rounded to bf16 in the kernel) -> f32 out.
int bcsr_spmm_bf16(const void* data, const void* block_cols, const void* items, const void* x,
                   void* out, void* ws, void* counters, int n_items, int n_slots, int n_rows,
                   int n_cols, int h, void* stream) {
  return launch<__nv_bfloat16, false>(data, nullptr, block_cols, items, x, out, ws, counters,
                                      n_items, n_slots, n_rows, n_cols, h, stream);
}

// B2. f32 tiles, f32 x -> adds into out [n_rows, h], which the caller zeroes.
int bcsr_spmm_stream_f32(const void* data, const void* block_rows, const void* block_cols,
                         const void* x, void* out, int n_tiles, int n_rows, int n_cols, int h,
                         void* stream) {
  return launch<float, true>(data, block_rows, block_cols, nullptr, x, out, nullptr, nullptr,
                             n_tiles, 0, n_rows, n_cols, h, stream);
}

// B2. bf16 tiles, f32 x (rounded to bf16 in the kernel) -> adds into out.
int bcsr_spmm_stream_bf16(const void* data, const void* block_rows, const void* block_cols,
                          const void* x, void* out, int n_tiles, int n_rows, int n_cols, int h,
                          void* stream) {
  return launch<__nv_bfloat16, true>(data, block_rows, block_cols, nullptr, x, out, nullptr,
                                     nullptr, n_tiles, 0, n_rows, n_cols, h, stream);
}

}  // extern "C"
