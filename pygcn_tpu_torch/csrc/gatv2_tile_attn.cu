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
// Design: the scheme of gat_tile_attn.cu (B3/B5/B6) with v2's operands. One
// CTA of 128 threads owns one (head, block row), blockIdx.x = block_row * H +
// head, and loops over the row's tiles; thread i owns row i of the block; the
// mask comes from warp ballots and is never stored (gat_tile_common.cuh);
// every output is written once, with no atomics. A block row without tiles
// writes num = den = 0, m = NEG and zero gradients.
//
// Per tile the CTA stages the column side's [128, F] slab of its head in
// shared memory: B7/B8 the senders' sl, which serves both the logit and the
// aggregation (or dnum . sl); B9 the receivers' sr and dnum, with their m and
// dden. a[h, :F] sits in shared memory too: every read of it, and of a staged
// row, is the same address across the warp (a broadcast, 16 bytes at a time).
//
// Registers are the hazard: a thread's own rows are F floats each. B7 keeps
// sr[v,h.] and num[F] in registers (2F); B8 keeps sr[v,h.], dsr[F] and
// dapart[F] (3F: 120 at F = 40) and its own dnum row in shared memory,
// transposed ([F][128], so the warp's 32 lanes read 32 banks); B9 keeps
// sl[u,h.] and dsl[F] (2F). A slot reads its staged row and a[h, :] from
// shared memory again for its second pass (reread_shared) instead of holding
// them in registers across the pass.
//
// B7 takes an online softmax one edge at a time rather than one tile at a time
// (B3's order): the v2 logit costs F FMAs and a LeakyReLU per slot, so it is
// evaluated once, and a row whose running max rises rescales den and num[F] by
// corr = exp(m_old - e) right there (0 with den = 0 for a row still at NEG).
// The result is the same softmax; rounding differs from the plain version's
// (which exponentiates once against the final max) by a few ulps per rescale.
//
// Bound on an H100 SXM at the ogbn-arxiv hybrid (2863 f32 tiles, 3.1M tile
// edges, N = 169,343): each launch must read the tiles as stored (0.19 GB) plus
// the [N, H F] operand rows and outputs, 0.27-0.42 GB in all, about
// 0.08-0.12 ms at 3.35 TB/s; the 7F+4 to 13F+4 operations per tile edge and
// head take under 0.05 ms at the 67 TFLOP/s f32 rate: bound by bytes. Like
// B3/B5/B6, these kernels evaluate about 90% of the slots of a 7%-full tile,
// now at F-fold cost a slot, and one CTA walks each block row, so the longest
// row (43 tiles) sets the tail. Skipping by edge lists, tensor cores and
// splitting long rows are later work.
//
// Precision: expf (not __expf) and f32 FMA, no TF32. Ragged shapes are masked
// in the kernel: operand rows past n read as zero and output rows past n are
// not written. Per-head widths F <= MAX_F run on the kernel compiled for the
// next width FP, with the extra columns zero (a zero a[h,f] adds nothing to e)
// and never written. Plain C interface, loaded with ctypes.

#include "gat_tile_common.cuh"

namespace {

using namespace gat_tile;

// Row `row` of the head's F columns of x [n, H*F] into dst[FP], zero past n and F.
template <int FP>
__device__ __forceinline__ void load_row(float dst[FP], const float* x, long long row, int n,
                                         int hf, int head, int f) {
#pragma unroll
  for (int k = 0; k < FP; ++k)
    dst[k] = (row < n && k < f) ? x[row * hf + static_cast<long long>(head) * f + k] : 0.f;
}

// a[head, :f] into a_sh[FP], zero past f (THREADS >= MAX_F).
__device__ __forceinline__ void stage_a(float* a_sh, const float* a, int head, int f, int fp) {
  if (threadIdx.x < fp) a_sh[threadIdx.x] = threadIdx.x < f ? a[head * f + threadIdx.x] : 0.f;
}

// The v2 logit of one slot: sum_f a[f] leaky(own[f] + xj[f]), f in order.
template <int FP>
__device__ __forceinline__ float v2_logit(const float* a_sh, const float* xj, const float own[FP],
                                          float slope) {
  const float4* x4 = reinterpret_cast<const float4*>(xj);
  const float4* a4 = reinterpret_cast<const float4*>(a_sh);
  float e = 0.f;
#pragma unroll
  for (int q = 0; q < FP / 4; ++q) {
    const float4 x = x4[q], av = a4[q];
    e = fmaf(av.x, leaky(own[4 * q + 0] + x.x, slope), e);
    e = fmaf(av.y, leaky(own[4 * q + 1] + x.y, slope), e);
    e = fmaf(av.z, leaky(own[4 * q + 2] + x.z, slope), e);
    e = fmaf(av.w, leaky(own[4 * q + 3] + x.w, slope), e);
  }
  return e;
}

__device__ __forceinline__ float dleaky(float pre, float slope) { return pre >= 0.f ? 1.f : slope; }

// A compiler barrier: shared-memory values read before it are read again after
// it rather than kept in registers (the staged row of a slot, and a[h, :],
// which is invariant across the column loop and would otherwise be hoisted).
// At F = 40 it took B7 from 201 to 160 registers and B8 from 255 with a spill
// to 246 without one (ptxas -v, sm_90a).
__device__ __forceinline__ void reread_shared() { asm volatile("" ::: "memory"); }

template <int FP>
__global__ void __launch_bounds__(THREADS)
gatv2_fwd_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                 const int* __restrict__ block_row_ptr, const float* __restrict__ sl,
                 const float* __restrict__ sr, const float* __restrict__ a,
                 float* __restrict__ num_out, float* __restrict__ den_out,
                 float* __restrict__ m_out, int n, int h, int f, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* sl_sh = smem;            // [TK][FP]: the tile's senders
  float* a_sh = smem + TK * FP;   // [FP]
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f;
  const long long v = static_cast<long long>(br) * TM + threadIdx.x;
  float srv[FP], acc[FP];
  load_row<FP>(srv, sr, v, n, hf, head, f);
#pragma unroll
  for (int k = 0; k < FP; ++k) acc[k] = 0.f;
  stage_a(a_sh, a, head, f, FP);
  float m = NEG, den = 0.f;

  const int t_end = block_row_ptr[br + 1];
  for (int t = block_row_ptr[br]; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;
    __syncthreads();  // the previous tile's slab is no longer read
    stage_feats<FP>(sl_sh, sl, col0, n, hf, head, f);
    uint32_t w[4];
    mask_words(tile_ptr(tiles, bf16, t), bf16, w);
    __syncthreads();

    for_columns(w, [&](int j, bool on) {
      const float* slj = sl_sh + j * FP;
      const float e = v2_logit<FP>(a_sh, slj, srv, slope);
      if (on && e > m) {
        const float corr = expf(m - e);  // from NEG: 0, with den and num still 0
        den *= corr;
#pragma unroll
        for (int k = 0; k < FP; ++k) acc[k] *= corr;
        m = e;
      }
      const float p = on ? expf(e - m) : 0.f;
      den += p;
      reread_shared();
      const float4* s4 = reinterpret_cast<const float4*>(slj);
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 s = s4[q];
        acc[4 * q + 0] = fmaf(p, s.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(p, s.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(p, s.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(p, s.w, acc[4 * q + 3]);
      }
    });
  }
  if (v < n) {
    float* dst = num_out + v * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) dst[k] = acc[k];
    den_out[v * h + head] = den;
    m_out[v * h + head] = m;
  }
}

template <int FP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_recv_kernel(const void* __restrict__ tiles, int bf16, const int* __restrict__ block_cols,
                      const int* __restrict__ block_row_ptr, const float* __restrict__ sl,
                      const float* __restrict__ sr, const float* __restrict__ a,
                      const float* __restrict__ m_in, const float* __restrict__ dnum,
                      const float* __restrict__ dden, float* __restrict__ dsr_out,
                      float* __restrict__ dapart_out, int n, int h, int f, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* sl_sh = smem;                // [TK][FP]: the tile's senders
  float* dn_sh = smem + TK * FP;      // [FP][TM]: each thread's own dnum row, transposed
  float* a_sh = dn_sh + FP * TM;      // [FP]
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f;
  const int i = threadIdx.x;
  const long long v = static_cast<long long>(br) * TM + i;
  float srv[FP], gsr[FP], gap[FP];
  load_row<FP>(srv, sr, v, n, hf, head, f);
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    dn_sh[k * TM + i] =
        (v < n && k < f) ? dnum[v * hf + static_cast<long long>(head) * f + k] : 0.f;
    gsr[k] = 0.f;
    gap[k] = 0.f;
  }
  stage_a(a_sh, a, head, f, FP);
  const float mv = node(m_in, v, n, h, head);
  const float dd = node(dden, v, n, h, head);

  const int t_end = block_row_ptr[br + 1];
  for (int t = block_row_ptr[br]; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;
    __syncthreads();
    stage_feats<FP>(sl_sh, sl, col0, n, hf, head, f);
    uint32_t w[4];
    mask_words(tile_ptr(tiles, bf16, t), bf16, w);
    __syncthreads();

    for_columns(w, [&](int j, bool on) {
      const float4* s4 = reinterpret_cast<const float4*>(sl_sh + j * FP);
      const float4* a4 = reinterpret_cast<const float4*>(a_sh);
      const float e = v2_logit<FP>(a_sh, sl_sh + j * FP, srv, slope);
      float gdot = 0.f;
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 s = s4[q];
        gdot = fmaf(dn_sh[(4 * q + 0) * TM + i], s.x, gdot);
        gdot = fmaf(dn_sh[(4 * q + 1) * TM + i], s.y, gdot);
        gdot = fmaf(dn_sh[(4 * q + 2) * TM + i], s.z, gdot);
        gdot = fmaf(dn_sh[(4 * q + 3) * TM + i], s.w, gdot);
      }
      const float p = on ? expf(e - mv) : 0.f;
      const float de = p * (gdot + dd);
      reread_shared();
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 s = s4[q], av = a4[q];
        const float s_[4] = {s.x, s.y, s.z, s.w}, a_[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * q + c;
          const float pre = srv[k] + s_[c];
          gsr[k] = fmaf(de, a_[c] * dleaky(pre, slope), gsr[k]);
          gap[k] = fmaf(de, leaky(pre, slope), gap[k]);
        }
      }
    });
  }
  if (v < n) {
    const long long o = v * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) {
        dsr_out[o + k] = gsr[k];
        dapart_out[o + k] = gap[k];
      }
  }
}

template <int FP>
__global__ void __launch_bounds__(THREADS)
gatv2_bwd_send_kernel(const void* __restrict__ tiles_t, int bf16,
                      const int* __restrict__ block_cols, const int* __restrict__ block_row_ptr,
                      const float* __restrict__ sl, const float* __restrict__ sr,
                      const float* __restrict__ a, const float* __restrict__ m_in,
                      const float* __restrict__ dnum, const float* __restrict__ dden,
                      float* __restrict__ dsl_out, int n, int h, int f, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* sr_sh = smem;                // [TK][FP]: the tile's receivers
  float* dn_sh = sr_sh + TK * FP;     // [TK][FP]
  float* m_sh = dn_sh + TK * FP;      // [TK]
  float* dd_sh = m_sh + TK;           // [TK]
  float* a_sh = dd_sh + TK;           // [FP]
  const int head = blockIdx.x % h, br = blockIdx.x / h;
  const int hf = h * f;
  const long long u = static_cast<long long>(br) * TM + threadIdx.x;  // sender
  float slu[FP], g[FP];
  load_row<FP>(slu, sl, u, n, hf, head, f);
#pragma unroll
  for (int k = 0; k < FP; ++k) g[k] = 0.f;
  stage_a(a_sh, a, head, f, FP);

  const int t_end = block_row_ptr[br + 1];
  for (int t = block_row_ptr[br]; t < t_end; ++t) {
    const long long col0 = static_cast<long long>(block_cols[t]) * TK;  // receivers
    __syncthreads();
    m_sh[threadIdx.x] = node(m_in, col0 + threadIdx.x, n, h, head);
    dd_sh[threadIdx.x] = node(dden, col0 + threadIdx.x, n, h, head);
    stage_feats<FP>(sr_sh, sr, col0, n, hf, head, f);
    stage_feats<FP>(dn_sh, dnum, col0, n, hf, head, f);
    uint32_t w[4];
    mask_words(tile_ptr(tiles_t, bf16, t), bf16, w);
    __syncthreads();

    for_columns(w, [&](int j, bool on) {
      const float4* x4 = reinterpret_cast<const float4*>(sr_sh + j * FP);
      const float4* d4 = reinterpret_cast<const float4*>(dn_sh + j * FP);
      const float4* a4 = reinterpret_cast<const float4*>(a_sh);
      const float e = v2_logit<FP>(a_sh, sr_sh + j * FP, slu, slope);
      float gdot = 0.f;
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 d = d4[q];
        gdot = fmaf(slu[4 * q + 0], d.x, gdot);
        gdot = fmaf(slu[4 * q + 1], d.y, gdot);
        gdot = fmaf(slu[4 * q + 2], d.z, gdot);
        gdot = fmaf(slu[4 * q + 3], d.w, gdot);
      }
      const float p = on ? expf(e - m_sh[j]) : 0.f;
      const float de = p * (gdot + dd_sh[j]);
      reread_shared();
#pragma unroll
      for (int q = 0; q < FP / 4; ++q) {
        const float4 x = x4[q], d = d4[q], av = a4[q];
        const float x_[4] = {x.x, x.y, x.z, x.w}, d_[4] = {d.x, d.y, d.z, d.w};
        const float a_[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * q + c;
          const float pre = slu[k] + x_[c];
          g[k] = fmaf(p, d_[c], g[k]);
          g[k] = fmaf(de, a_[c] * dleaky(pre, slope), g[k]);
        }
      }
    });
  }
  if (u < n) {
    float* dst = dsl_out + u * hf + static_cast<long long>(head) * f;
#pragma unroll
    for (int k = 0; k < FP; ++k)
      if (k < f) dst[k] = g[k];
  }
}

// The width-FP instance of `kernel` with `smem` bytes of dynamic shared memory
// (above 48 KB only after the opt-in), launched on `stream`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int n_block_rows, int h, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid_of(n_block_rows, h), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The compiled width pick_width takes for f, and each kernel's shared memory at it.
int width_of(int f) {
  return f <= 4 ? 4 : f <= 8 ? 8 : f <= 16 ? 16 : f <= 32 ? 32 : f <= 40 ? 40 : 64;
}
size_t fwd_smem(int fp) { return sizeof(float) * (TK * fp + fp); }
size_t recv_smem(int fp) { return sizeof(float) * (TK * fp + fp * TM + fp); }
size_t send_smem(int fp) { return sizeof(float) * (2 * TK * fp + 2 * TK + fp); }

}  // namespace

extern "C" {

// Tile shape and the largest per-head width the kernels are compiled for.
int gatv2_tile_attn_config(int* tm, int* tk, int* max_f) {
  *tm = TM;
  *tk = TK;
  *max_f = MAX_F;
  return 0;
}

// B7. Returns the CUDA error of the launch (0 on success).
int gatv2_tile_fwd(const void* tiles, const void* block_cols, const void* block_row_ptr,
                   const void* sl, const void* sr, const void* a, void* num, void* den, void* m,
                   int n_block_rows, int n, int h, int f, int tile_bf16, float slope,
                   void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_TILE_WIDTHS(gatv2_fwd_kernel)), fwd_smem(width_of(f)),
                n_block_rows, h, stream, tiles, tile_bf16,
                static_cast<const int*>(block_cols), static_cast<const int*>(block_row_ptr),
                static_cast<const float*>(sl), static_cast<const float*>(sr),
                static_cast<const float*>(a), static_cast<float*>(num), static_cast<float*>(den),
                static_cast<float*>(m), n, h, f, slope);
}

// B8 over the forward tiles.
int gatv2_tile_bwd_recv(const void* tiles, const void* block_cols, const void* block_row_ptr,
                        const void* sl, const void* sr, const void* a, const void* m,
                        const void* dnum, const void* dden, void* dsr, void* dapart,
                        int n_block_rows, int n, int h, int f, int tile_bf16, float slope,
                        void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_TILE_WIDTHS(gatv2_bwd_recv_kernel)),
                recv_smem(width_of(f)), n_block_rows, h, stream, tiles, tile_bf16,
                static_cast<const int*>(block_cols), static_cast<const int*>(block_row_ptr),
                static_cast<const float*>(sl), static_cast<const float*>(sr),
                static_cast<const float*>(a), static_cast<const float*>(m),
                static_cast<const float*>(dnum), static_cast<const float*>(dden),
                static_cast<float*>(dsr), static_cast<float*>(dapart), n, h, f, slope);
}

// B9 over the transpose tiles (block rows are senders).
int gatv2_tile_bwd_send(const void* tiles_t, const void* block_cols, const void* block_row_ptr,
                        const void* sl, const void* sr, const void* a, const void* m,
                        const void* dnum, const void* dden, void* dsl, int n_block_rows, int n,
                        int h, int f, int tile_bf16, float slope, void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pick_width(f, GAT_TILE_WIDTHS(gatv2_bwd_send_kernel)),
                send_smem(width_of(f)), n_block_rows, h, stream, tiles_t, tile_bf16,
                static_cast<const int*>(block_cols), static_cast<const int*>(block_row_ptr),
                static_cast<const float*>(sl), static_cast<const float*>(sr),
                static_cast<const float*>(a), static_cast<const float*>(m),
                static_cast<const float*>(dnum), static_cast<const float*>(dden),
                static_cast<float*>(dsl), n, h, f, slope);
}

}  // extern "C"
