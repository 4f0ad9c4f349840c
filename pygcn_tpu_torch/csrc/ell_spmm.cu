// Kernel E1 for Hopper (sm_90a): SpMM over the bucketed ELL layout of
// pygcn_tpu_torch/ops/ell.py, one pass over its virtual rows,
//
//   y[row, :] = sum over the virtual rows v of row, in part order, of
//               sum over the slots s < len[v], in slot order, of vals[v][s] * x[cols[v][s], :].
//
// E1 replaces no TPU kernel: the JAX package leaves this product to XLA
// (pygcn_tpu/ops/ell.py:159 ell_spmm_raw, a take and a segment_sum). The
// port's plain version (ops/ell.py ell_spmm_plain) gathers each bucket into a
// dense [Nb * K, H] tensor, multiplies it by the values into a second one,
// sums that over K and merges the sums into a zero-filled output with an
// index_add_: each slot's row crosses device memory about five times, in
// 4 launches a bucket and a fill. E1 does the same work in one launch that
// writes nothing but y (and the partial rows of split rows).
//
// Bound on an H100 SXM: bytes. Two operations per slot and column need under
// 2% of the f32 rate. The least traffic is x once, the valid slots (8 bytes
// each), the work items (32 bytes each) and y once: at the power-law
// benchmark graph's residual (3.57M valid slots on 173K virtual rows, 169,343
// rows) and H = 256, 0.38 GB, 0.11 ms at 3.35 TB/s. A gather whose operand
// rows do not stay in the 50 MB L2 pays every valid slot's row: 3.66 GB,
// 1.09 ms. The design:
//
// - Work items, built once per layout by the wrapper and kept in ell.cache:
//   one per virtual row with valid slots, holding its bucket, first slot,
//   length, output row and, for a row split over several virtual rows, its
//   partial's place. build_ell pads a virtual row at its end, so its length
//   skips the padding: no padding slot is read. A row with no valid slot gets
//   an item of length 0 that writes its zeros, so y needs no zero fill. One
//   launch a product runs the items of every bucket, the widest bucket first.
// - Lanes run across columns: 16-byte loads (float4) where H % 4 == 0 and x,
//   y and the workspace are 16-byte aligned, 4-byte loads otherwise. A row of
//   C such vectors takes min(C, 32) lanes, so narrow rows share a warp (H =
//   40: 10 lanes an item, 3 items a warp); wider rows take up to 4 vectors a
//   lane and loop over column chunks (folded batches such as H = 640).
// - An item's lanes read its slots' columns and values once, coalesced, and
//   hand them round by shuffle; each lane keeps UNROLL operand-row loads in
//   flight before their FMAs, which sum in f32 registers in slot order.
// - Split rows (degree above the widest bucket; the tail chunk may sit in a
//   smaller bucket): each part writes its partial row to a workspace, fences
//   and counts its arrival on the row's counter; the part that arrives last
//   sums the partials in part order (the row's chunk order), writes y and
//   resets the counter for the next launch, as B1 merges its split block
//   rows. No float atomics: the same bits every launch. No item is wider than
//   the widest bucket, so the longest row does not set the launch's tail.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int ITEM_INTS = 8;  // bucket, first slot, length, row | part, first part, parts, 0
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void fma_into(float& a, float w, float b) { a = fmaf(w, b, a); }
__device__ __forceinline__ void fma_into(float4& a, float w, const float4& b) {
  a.x = fmaf(w, b.x, a.x);
  a.y = fmaf(w, b.y, a.y);
  a.z = fmaf(w, b.z, a.z);
  a.w = fmaf(w, b.w, a.w);
}
__device__ __forceinline__ void add_into(float& a, float b) { a += b; }
__device__ __forceinline__ void add_into(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One warp serves `groups` items of `lanes` lanes each. tables: the buckets'
// cols pointers, then their vals pointers. items: ITEM_INTS ints an item
// (two int4): slots [slot, slot + length) of bucket `bucket` summed into row
// `row`, or with part >= 0 into workspace row `part`; a split row's partials
// are workspace rows first .. first + parts - 1 and its arrival counter is
// counters[first]. V: vectors (float4 with VEC, else float) a lane holds of
// one column chunk of lanes * V vectors; vecs: vectors a row of x and y.
template <int V, bool VEC>
__global__ void __launch_bounds__(THREADS)
ell_rows_f32_kernel(const long long* __restrict__ tables, int n_buckets,
                    const int4* __restrict__ items, long long n_items,
                    const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int vecs, int lanes,
                    int groups) {
  using T = std::conditional_t<VEC, float4, float>;
  constexpr int UNROLL = V == 4 ? 2 : 4;  // operand rows in flight a lane
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  if (warp * groups >= n_items) return;  // the same in the whole warp
  const int grp = lane / lanes;
  const int sub = lane - grp * lanes;
  const int base = grp * lanes;  // first lane of the group
  const long long item = warp * groups + grp;
  const bool has = grp < groups && item < n_items;
  int4 a = make_int4(0, 0, 0, 0);   // bucket, slot, length, row
  int4 p = make_int4(-1, -1, 1, 0); // part, first part, parts
  if (has) {
    a = __ldg(items + 2 * item);
    p = __ldg(items + 2 * item + 1);
  }
  const int len = a.z;
  const int* cols = reinterpret_cast<const int*>(tables[a.x]) + a.y;
  const float* vals = reinterpret_cast<const float*>(tables[n_buckets + a.x]) + a.y;
  const int maxlen = __reduce_max_sync(FULL, len);
  const T* xv = reinterpret_cast<const T*>(x);
  T* dst = p.x < 0 ? reinterpret_cast<T*>(out) + static_cast<size_t>(a.w) * vecs
                   : reinterpret_cast<T*>(ws) + static_cast<size_t>(p.x) * vecs;

  for (int c0 = 0; c0 < vecs; c0 += lanes * V) {
    T acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) set_zero(acc[q]);
    for (int s0 = 0; s0 < maxlen; s0 += lanes) {
      const int j = s0 + sub;
      const bool ok = j < len;
      const int cj = ok ? __ldg(cols + j) : 0;
      const float vj = ok ? __ldg(vals + j) : 0.f;
      const int n = min(lanes, maxlen - s0);  // slots of this round, the same in the warp
      for (int t = 0; t < n; t += UNROLL) {
        T r[UNROLL][V];
        float w[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int src = (base + min(t + u, lanes - 1)) & 31;
          const int c = __shfl_sync(FULL, cj, src);
          w[u] = __shfl_sync(FULL, vj, src);
          const bool live = t + u < n && s0 + t + u < len;
#pragma unroll
          for (int q = 0; q < V; ++q) {
            const int col = c0 + sub + q * lanes;
            if (live && col < vecs) {
              r[u][q] = __ldg(xv + static_cast<size_t>(c) * vecs + col);
            } else {
              set_zero(r[u][q]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (t + u < n && s0 + t + u < len) {
#pragma unroll
            for (int q = 0; q < V; ++q) fma_into(acc[q], w[u], r[u][q]);
          }
        }
      }
    }
    if (has) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int col = c0 + sub + q * lanes;
        if (col < vecs) dst[col] = acc[q];
      }
    }
  }

  const bool split = has && p.x >= 0;
  if (!__any_sync(FULL, split)) return;
  __threadfence();  // this lane's partial columns are visible before the arrival
  __syncwarp();
  int last = 0;
  if (split && sub == 0) {
    int* counter = counters + p.y;
    last = atomicAdd(counter, 1) + 1 == p.z;
    if (last) *counter = 0;  // every part has arrived: ready for the next launch
  }
  last = __shfl_sync(FULL, last, base & 31);
  if (!last) return;
  __threadfence();
  // The last part of the row sums the partials in part order: the same bits
  // whichever part arrives last.
  const T* part0 = reinterpret_cast<const T*>(ws) + static_cast<size_t>(p.y) * vecs;
  T* y = reinterpret_cast<T*>(out) + static_cast<size_t>(a.w) * vecs;
  for (int col = sub; col < vecs; col += lanes) {
    T s = __ldcg(part0 + col);
    for (int k = 1; k < p.z; ++k) add_into(s, __ldcg(part0 + static_cast<size_t>(k) * vecs + col));
    y[col] = s;
  }
}

template <int V, bool VEC>
int launch_one(const void* tables, int n_buckets, const void* items, long long n_items,
               const void* x, void* out, void* ws, void* counters, int vecs, int lanes,
               int groups, void* stream) {
  const long long warps = (n_items + groups - 1) / groups;
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ell_rows_f32_kernel<V, VEC><<<static_cast<unsigned>(blocks), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tables), n_buckets, static_cast<const int4*>(items), n_items,
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), vecs, lanes, groups);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The work-item width the kernel is compiled for; the Python wrapper checks it.
int ell_spmm_config(int* item_ints) {
  *item_ints = ITEM_INTS;
  return 0;
}

// E1. tables: 2 * n_buckets device pointers (each bucket's int32 cols
// [Nb * K], then each bucket's f32 vals); items [n_items, ITEM_INTS] int32;
// f32 x [n_cols, h] -> f32 out [n_rows, h], every row written; ws: one
// partial row [h] for each part of a split row (null when there are none);
// counters: one int per part, zero between launches. Returns the CUDA error
// of the launch (0 on success).
int ell_spmm_f32(const void* tables, int n_buckets, const void* items, long long n_items,
                 const void* x, void* out, void* ws, void* counters, int h, void* stream) {
  if (n_items <= 0 || h <= 0) return 0;
  if (n_buckets < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = h % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(ws);
  const int vecs = vec ? h / 4 : h;
  const int lanes = vecs < 32 ? vecs : 32;
  const int groups = 32 / lanes;
  auto go = [&](auto fn) {
    return fn(tables, n_buckets, items, n_items, x, out, ws, counters, vecs, lanes, groups,
              stream);
  };
  if (vecs <= 32) return vec ? go(launch_one<1, true>) : go(launch_one<1, false>);
  if (vecs <= 64) return vec ? go(launch_one<2, true>) : go(launch_one<2, false>);
  return vec ? go(launch_one<4, true>) : go(launch_one<4, false>);
}

}  // extern "C"
