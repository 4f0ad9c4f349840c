// Kernel E2 for Hopper (sm_90a): SpMM over the column-panel layout of
// pygcn_tpu_torch/ops/colpanel.py, one launch a product,
//
//   y[row, :] = sum over the row's virtual rows v, in panel, bucket and slot order, of
//               sum over the slots s < len[v] of vals[v][s] * x[start[panel(v)] + cols[v][s], :].
//
// E2 replaces no TPU kernel: the JAX package leaves this product to XLA
// (pygcn_tpu/ops/colpanel.py:183 col_panel_spmm_raw, a take and one
// segment_sum). The port's plain chain (ops/colpanel.py col_panel_spmm_plain)
// runs once per live bucket of every sender panel: a gather of the bucket into
// a dense [Nb * K, H] tensor, its product by the values into a second one, a
// sum over K, a segment_reduce where rows repeat and an index_add_ into a
// zero-filled output; at the ogbn-products benchmark graph that is about
// 5,900 bucket products and 30,000 launches an epoch, each slot's row crossing
// device memory about five times. E2 does the whole product in one launch
// that writes nothing but y (and the partial rows of hub rows).
//
// Bound on an H100 SXM: bytes. Two operations per slot and column need under
// 2% of the f32 rate. The least traffic is x once, the valid slots (8 bytes
// each), the schedule (8 bytes a virtual row, 4 an output row) and y once. A
// gather whose operand rows miss the 50 MB L2 pays every slot's row instead.
// On a locality-ordered community graph most of a row's edges fall in its own
// community, inside one panel, and neighbouring rows share those operand
// rows in L2; the edges across communities land in other panels, mostly one
// to a panel, and their rows come from device memory. The design:
//
// - Work item = one output row. Its references, built once per layout by the
//   wrapper and kept in pe.cache, list its virtual rows in every panel, in
//   panel, bucket and slot order, each as (first flat slot, bucket table <<
//   16 | length); the length comes from the layout's lens, so no padding slot
//   is read. The item sums them in f32 registers and writes y[row] once; a
//   row with no edge writes its zeros, so y needs no zero fill. No float
//   atomics: the same bits every launch. A panel's start is added to its
//   panel-local column ids here: the layout is read as stored.
// - An item flattens its references into one stream of slots: its lanes read
//   up to `lanes` references at a time (coalesced), take a prefix sum of
//   their lengths by shuffle, and then cover the stream `lanes` slots at a
//   time, each lane finding its slot's reference from the bits of the
//   references that start in the batch. So a row of many one-edge virtual
//   rows (the edges across communities) keeps as many operand-row loads in
//   flight as a row of one long virtual row.
// - Lanes run across columns, as in E1: 16-byte loads (float4) where H % 4 ==
//   0 and x, y and the workspace are 16-byte aligned, 4-byte loads otherwise
//   (H = 47). A row of C such vectors takes min(C, 32) lanes, so narrow rows
//   share a warp; each lane keeps UNROLL operand-row loads in flight before
//   their FMAs.
// - Hub rows (more slots than the wrapper's cap) are cut at virtual-row
//   boundaries into parts, the first items of the launch, so they start
//   first and no row sets its tail. Each part writes its partial row to a
//   workspace, fences and counts its arrival on the row's counter; the part
//   that arrives last sums the partials in part order, writes y and resets
//   the counter for the next launch, as E1 merges its split rows. Only these
//   rows take workspace. The row's own item writes nothing.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int REF_INTS = 2;   // first slot, table << 16 | length
constexpr int PART_INTS = 8;  // row, first ref, end ref, 0 | part, first part, parts, 0
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

// One warp serves `groups` items of `lanes` lanes each: items 0 .. n_parts - 1
// are the hub rows' parts, then one item a row. tables: the buckets' cols
// pointers, their vals pointers, then each bucket's panel start, n_tables of
// each. row_ptr: row r's references are refs[row_ptr[r] .. row_ptr[r + 1]),
// each entry without its top bit, which marks a hub row. V: vectors (float4
// with VEC, else float) a lane holds of one column chunk of lanes * V vectors;
// vecs: vectors a row of x and y.
template <int V, bool VEC>
__global__ void __launch_bounds__(THREADS)
colpanel_rows_f32_kernel(const long long* __restrict__ tables, int n_tables,
                         const int* __restrict__ row_ptr, const int2* __restrict__ refs,
                         long long n_rows, const int4* __restrict__ parts, int n_parts,
                         const float* __restrict__ x, float* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters, int vecs, int lanes,
                         int groups) {
  using T = std::conditional_t<VEC, float4, float>;
  constexpr int UNROLL = V == 4 ? 2 : 8;  // operand rows in flight a lane
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const long long n_items = n_parts + n_rows;
  if (warp * groups >= n_items) return;  // the same in the whole warp
  const int grp = lane / lanes;
  const int sub = lane - grp * lanes;
  const int base = grp * lanes;  // first lane of the group
  const unsigned own = (lanes == 32 ? FULL : (1u << lanes) - 1u) << base;  // the group's lanes
  const long long item = warp * groups + grp;
  bool writes = grp < groups && item < n_items;
  int row = 0, begin = 0, end = 0;
  int4 p = make_int4(-1, -1, 1, 0);  // part, first part, parts
  if (writes) {
    if (item < n_parts) {
      const int4 a = __ldg(parts + 2 * item);
      p = __ldg(parts + 2 * item + 1);
      row = a.x;
      begin = a.y;
      end = a.z;
    } else {
      row = static_cast<int>(item - n_parts);
      const int b = __ldg(row_ptr + row);
      begin = b & INT_MAX;
      end = __ldg(row_ptr + row + 1) & INT_MAX;
      if (b < 0) {  // a hub row: its parts sum it
        writes = false;
        end = begin;
      }
    }
  }
  const int n_refs = end - begin;
  const int max_refs = __reduce_max_sync(FULL, n_refs);
  const T* xv = reinterpret_cast<const T*>(x);
  T* dst = p.x < 0 ? reinterpret_cast<T*>(out) + static_cast<size_t>(row) * vecs
                   : reinterpret_cast<T*>(ws) + static_cast<size_t>(p.x) * vecs;

  for (int c0 = 0; c0 < vecs; c0 += lanes * V) {
    T acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) set_zero(acc[q]);
    for (int r0 = 0; r0 < max_refs; r0 += lanes) {
      // this round's references, one a lane, and where each starts in the
      // round's stream of slots (an inclusive prefix sum over the group)
      int first = 0, tl = 0;
      if (r0 + sub < n_refs) {
        const int2 ref = __ldg(refs + begin + r0 + sub);
        first = ref.x;
        tl = ref.y;
      }
      const int len = tl & 0xffff;
      int incl = len;
      for (int d = 1; d < lanes; d <<= 1) {
        const int v = __shfl_sync(FULL, incl, (lane - d) & 31);
        if (sub >= d) incl += v;
      }
      const int start = incl - len;
      // the lanes past the last group (lanes * groups < 32) have no slots
      int total = __shfl_sync(FULL, incl, (base + lanes - 1) & 31);
      if (grp >= groups) total = 0;
      const int max_total = __reduce_max_sync(FULL, total);
      int opened = 0;  // references of the round that start before this batch
      for (int s0 = 0; s0 < max_total; s0 += lanes) {
        const bool opens = len > 0 && start >= s0 && start < s0 + lanes;
        const unsigned starts =
            __reduce_or_sync(FULL, opens ? 1u << (base + start - s0) : 0u) & own;
        // the reference holding this lane's slot s0 + sub: the last one opened by it
        const int s = s0 + sub;
        const bool ok = s < total;
        const int r = opened + __popc(starts & ((2u << lane) - 1u)) - 1;
        const int src = base + (ok ? r : 0);
        const int r_first = __shfl_sync(FULL, first, src);
        const int r_tl = __shfl_sync(FULL, tl, src);
        const int r_start = __shfl_sync(FULL, start, src);
        opened += __popc(starts);
        int cj = 0;
        float vj = 0.f;
        if (ok) {
          const int t = r_tl >> 16;
          const int at = r_first + (s - r_start);
          cj = __ldg(reinterpret_cast<const int*>(tables[t]) + at) +
               static_cast<int>(tables[2 * n_tables + t]);
          vj = __ldg(reinterpret_cast<const float*>(tables[n_tables + t]) + at);
        }
        const int n = min(lanes, max_total - s0);  // slots of this batch, the same in the warp
        for (int t = 0; t < n; t += UNROLL) {
          T rr[UNROLL][V];
          float w[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int from = (base + min(t + u, lanes - 1)) & 31;
            const int c = __shfl_sync(FULL, cj, from);
            w[u] = __shfl_sync(FULL, vj, from);
            const bool live = t + u < n && s0 + t + u < total;
#pragma unroll
            for (int q = 0; q < V; ++q) {
              const int col = c0 + sub + q * lanes;
              if (live && col < vecs) {
                rr[u][q] = __ldg(xv + static_cast<size_t>(c) * vecs + col);
              } else {
                set_zero(rr[u][q]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (t + u < n && s0 + t + u < total) {
#pragma unroll
              for (int q = 0; q < V; ++q) fma_into(acc[q], w[u], rr[u][q]);
            }
          }
        }
      }
    }
    if (writes) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int col = c0 + sub + q * lanes;
        if (col < vecs) dst[col] = acc[q];
      }
    }
  }

  const bool split = writes && p.x >= 0;
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
  T* y = reinterpret_cast<T*>(out) + static_cast<size_t>(row) * vecs;
  for (int col = sub; col < vecs; col += lanes) {
    T s = __ldcg(part0 + col);
    for (int k = 1; k < p.z; ++k) add_into(s, __ldcg(part0 + static_cast<size_t>(k) * vecs + col));
    y[col] = s;
  }
}

template <int V, bool VEC>
int launch_one(const void* tables, int n_tables, const void* row_ptr, const void* refs,
               long long n_rows, const void* parts, int n_parts, const void* x, void* out,
               void* ws, void* counters, int vecs, int lanes, int groups, void* stream) {
  const long long warps = (n_parts + n_rows + groups - 1) / groups;
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  colpanel_rows_f32_kernel<V, VEC><<<static_cast<unsigned>(blocks), THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tables), n_tables, static_cast<const int*>(row_ptr),
      static_cast<const int2*>(refs), n_rows, static_cast<const int4*>(parts), n_parts,
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), vecs, lanes, groups);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The reference and part widths the kernel is compiled for; the Python
// wrapper checks them.
int colpanel_spmm_config(int* ref_ints, int* part_ints) {
  *ref_ints = REF_INTS;
  *part_ints = PART_INTS;
  return 0;
}

// E2. tables: 3 * n_tables int64 (each bucket's int32 cols [Nb * K] pointer,
// then each bucket's f32 vals pointer, then each bucket's panel start);
// row_ptr [n_rows + 1] int32 and refs [n_refs, REF_INTS] int32, the schedule;
// parts [n_parts, PART_INTS] int32, the hub rows' parts; f32 x [n_cols, h] ->
// f32 out [n_rows, h], every row written; ws: one partial row [h] a part (null
// when there are none); counters: one int a part, zero between launches.
// Returns the CUDA error of the launch (0 on success).
int colpanel_spmm_f32(const void* tables, int n_tables, const void* row_ptr, const void* refs,
                      long long n_rows, const void* parts, int n_parts, const void* x, void* out,
                      void* ws, void* counters, int h, void* stream) {
  if (n_rows <= 0 || h <= 0) return 0;
  if (n_tables < 0 || n_parts < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = h % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(ws);
  const int vecs = vec ? h / 4 : h;
  const int lanes = vecs < 32 ? vecs : 32;
  const int groups = 32 / lanes;
  auto go = [&](auto fn) {
    return fn(tables, n_tables, row_ptr, refs, n_rows, parts, n_parts, x, out, ws, counters,
              vecs, lanes, groups, stream);
  };
  if (vecs <= 32) return vec ? go(launch_one<1, true>) : go(launch_one<1, false>);
  if (vecs <= 64) return vec ? go(launch_one<2, true>) : go(launch_one<2, false>);
  return vec ? go(launch_one<4, true>) : go(launch_one<4, false>);
}

}  // extern "C"
