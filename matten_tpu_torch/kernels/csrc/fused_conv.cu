// Fused uvu tensor-product convolution, forward (K1), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel matten_tpu/kernels/fused_conv.py::_build_fwd2.
// Contract (the same as the JAX `_reference`, gather -> TP -> segment sum):
//
//   out[n, o] = pw[o] * sum_{e : dst[e] = n} w[e, w_idx(o)]
//               * sum_{m1} t_e[t_idx(o) + m1 * d3(o)] * x[src[e], x_idx(o) + m1]
//   t_e[i]    = sum_{m2} C_i[m2] * sh[e, sh_off(i) + m2]
//
// where o runs over the plan's output components; each o belongs to exactly
// one path p = (l1, l2, l3) and channel u, and i over the (m1, m3) entries
// of the CG blocks C = wigner_3j(l1, l2, l3) that the paths share.
//
// Design.
// * Work unit: an item, a run of at most TE = 16 consecutive edges of ONE
//   destination (edges arrive sorted by destination). Items number
//   sum_n ceil(deg(n) / 16), 1488 on the flagship batch (the grid is the
//   static bound min(E, (E + n_out * 15) / 16), 1644 there: the blocks past
//   the count read it from item_ptr[n_out] and exit), and each does about
//   the same work, so the highest-degree node (159 edges there) no longer
//   sets the time as it did with one block per node. One block per item;
//   the block finds its (node, first edge) by a binary search over
//   item_ptr = cumsum(ceil(deg / 16)), which the wrapper's per-batch edge
//   plan holds with the dst CSR offsets.
// * Partial rows, no atomics: the block writes pw * (the item's sum) as one
//   row of a scratch [items, dout], and segment_sum.cu adds each node's rows
//   in item order into out (nodes without edges get zeros). Every sum has a
//   fixed order, so the result is bitwise reproducible.
// * Staging, as in the merged backward (fused_conv_common.cuh): the item's
//   w rows (16-byte cp.async) and x[src] rows (4-byte cp.async) are copied
//   while the block stages the padded sh rows and contracts them with the CG
//   blocks into t_e [16][n_t | 1], one CG entry per thread over the item's
//   edges. At the production layer 3 (n_t 2067, dw 842, d1 246) that is
//   132 + 54 + 16 + 2 KB: one block of 24 warps per SM.
// * Tiers: a plan whose block does not fit the 227 KB a block may have
//   (wider multiplicities, or sh irreps above l = 4, whose t_e rows grow
//   with n_t) launches a smaller instance of the same kernel: the w rows
//   read from global memory (__ldg, coalesced in u, as the tasks read them
//   from shared memory), then items of 8 or 4 edges. The wrapper picks the
//   first tier that fits per plan (fused_conv.py::choose_tiers) and deals
//   the tasks for its item size; every production plan runs the first,
//   16 edges with the w rows staged.
// * Lanes: a warp task is (path p, up to 32 channels u); lane = (channel u,
//   edge group): nu = the channels (a power of two, up to 32) and 32 / nu
//   groups of the item's edges, so every production path (multiplicities
//   32, 16, 4, 2) fills the warp. A lane keeps the d3 outputs (u, m3) of its
//   channel in registers over its edges, with the (d1, d3) contraction
//   unrolled, then the edge groups are added by a butterfly of shuffles (a
//   fixed order) and the first group writes the partial row. The lanes of a
//   warp run one path, so the warp never diverges; t_e reads are broadcasts
//   within a group (odd row stride across groups), and w reads are
//   consecutive in u. The tasks are dealt to the 24 warps heaviest first by
//   the wrapper (fused_conv.py::tile_tables).
// * Irreps above l = 4 (d1 or d3 > 9) take one generic path, with d1 and
//   d3 read at run time and the d3 outputs done in blocks of at most
//   CONV_MAX_D accumulators, so its registers stay bounded for any l. It is
//   compiled only into the ANY_L instances, which the wrapper launches for
//   a plan with an irrep above l = 4 (its sh irreps included: t_e's
//   generic contraction); the unrolled (d1, d3) paths of l <= 4 are the
//   production ones, and the instances without ANY_L keep their code as
//   it was before the generic paths.
// * float32 on the CUDA cores: the contractions are d1, d3 <= 9 deep (11
//   at l = 5) with a different CG product per edge, far below wgmma's
//   64-row tiles, and TF32 would break the 1e-5 parity the checks hold.
// * Storage of sh and w: float or bf16 (a template over T; the JAX kernels'
//   `set_kernel_in_dtype`). At bf16 the w rows are staged at 2 bytes
//   (cp_async_rows copies the unaligned ends one element at a time) and
//   widened where a lane reads them, sh is widened as it is staged; x, the
//   arithmetic and the partial rows stay float32. The bound's w read halves.
//
// What bounds it on an H100: the function's inputs read once and its output
// written once are about 75 MB at layer 3 (w [E, dw] dominates: 21504 x 842
// x 4 B), 22 us at 3.35 TB/s; its float32 work, about 2 * (12k + 13k)
// multiply-adds per edge (t_e, then the contraction), about 1.1 GFLOP, 16 us
// at 67 TFLOP/s. The partial rows add a write and a read of [items, dout]
// (25 MB at layer 3). The phases of a block run one after the other (copy,
// t_e, the tasks) with one block per SM, and the tasks read an operand from
// shared memory for every multiply-add: shared-memory issue and latency,
// not device memory, set the time.

#include "fused_conv_common.cuh"

#define FWD_WARPS 24
#define FWD_THREADS (32 * FWD_WARPS)

template <typename T>
struct FwdArgs {
  const float* x;          // [n_in, d1]
  const T* sh;             // [E, d2]
  const T* w;              // [E, dw]
  const int* src;          // [E]
  const int* row_ptr;      // [n_out + 1] offsets of each destination's edges
  const int* item_ptr;     // [n_out + 1] offsets of each destination's items
  const int4* t_meta;      // [n_t]: cg offset, sh offset, d2_i, 0
  const float* cg_t;       // [rows, n_t]: C_i[m2] at m2 * n_t + i, 0 past d2_i
  const int* t_sh;         // [n_t]: offset of entry i's sh segment in a padded sh row
  const int* sh_src;       // [shp]: sh component of each padded slot, or -1
  const int4* groups;      // [irreps of in1]: x_off, d1, path begin, path end
  const int4* paths;       // [paths]: o_off, t_off, w_off, d3
  const float* path_pw;    // [paths]
  const int4* tasks;       // path, group, u0 | nu << 16, u count | ne << 16
  const int* warp_ptr;     // [FWD_WARPS + 1] offsets of each warp's tasks
  float* partial;          // [items, dout]
  int n_out, d1, d2, shp, dw, dout, n_t;
};

// w[j, w_off + u] of the lane's channel: from the staged rows (STAGE_W) or
// from global memory through the read-only cache (row stride dw either way)
template <bool STAGE_W, typename T>
static __device__ __forceinline__ float w_at(const T* wp, int j, int dw) {
  if constexpr (STAGE_W) return to_f32(wp[j * dw]);
  else return ldg_f32(wp + (size_t)j * dw);
}

// One lane's channel of one path over edges j0, j0 + ne, ... < nj of the
// item: acc[m3] = sum_j w[j, w_off + u] * sum_{m1} t_j[m1 * D3 + m3] x_j[m1];
// then the sum over the warp's edge groups (lanes lane ^ nu, ^ 2 nu, ...).
template <int D1, int D3, bool STAGE_W, typename T>
static __device__ __forceinline__ void item_path(
    const float* tp, int ts_stride, const float* xp, int xs_stride, const T* wp, int dw,
    int j0, int ne, int nj, int nu, float pw, float* orow) {
  float acc[D3];
#pragma unroll
  for (int m3 = 0; m3 < D3; ++m3) acc[m3] = 0.f;
  for (int j = j0; j < nj; j += ne) {
    const float* t = tp + j * ts_stride;
    float xv[D1];
#pragma unroll
    for (int m1 = 0; m1 < D1; ++m1) xv[m1] = xp[j * xs_stride + m1];
    const float wv = w_at<STAGE_W>(wp, j, dw);
#pragma unroll
    for (int m3 = 0; m3 < D3; ++m3) {
      float y = 0.f;
#pragma unroll
      for (int m1 = 0; m1 < D1; ++m1) y = fmaf(t[m1 * D3 + m3], xv[m1], y);
      acc[m3] = fmaf(wv, y, acc[m3]);
    }
  }
  for (int off = nu; off < 32; off <<= 1) {
#pragma unroll
    for (int m3 = 0; m3 < D3; ++m3) acc[m3] += __shfl_xor_sync(0xffffffffu, acc[m3], off);
  }
  if (orow) {
#pragma unroll
    for (int m3 = 0; m3 < D3; ++m3) orow[m3] = pw * acc[m3];
  }
}

template <int D1, bool STAGE_W, typename T>
static __device__ __forceinline__ void item_path_d3(
    int d3, const float* tp, int ts_stride, const float* xp, int xs_stride, const T* wp,
    int dw, int j0, int ne, int nj, int nu, float pw, float* orow) {
#define ITEM_PATH_D3(D3) \
  item_path<D1, D3, STAGE_W, T>(tp, ts_stride, xp, xs_stride, wp, dw, j0, ne, nj, nu, pw, orow)
  switch (d3) {  // the same for the whole warp
    case 1: ITEM_PATH_D3(1); break;
    case 3: ITEM_PATH_D3(3); break;
    case 5: ITEM_PATH_D3(5); break;
    case 7: ITEM_PATH_D3(7); break;
    default: ITEM_PATH_D3(9); break;  // d3 <= CONV_MAX_D here
  }
#undef ITEM_PATH_D3
}

// item_path for any d1 and d3 (the paths of irreps above l = 4): the same
// sums, with d1 and d3 read at run time and the outputs m3 taken in blocks
// of CONV_MAX_D, each block a pass over the lane's edges.
template <bool STAGE_W, typename T>
static __device__ __forceinline__ void item_path_any(
    int d1, int d3, const float* tp, int ts_stride, const float* xp, int xs_stride, const T* wp,
    int dw, int j0, int ne, int nj, int nu, float pw, float* orow) {
  for (int b0 = 0; b0 < d3; b0 += CONV_MAX_D) {
    const int nb = min(CONV_MAX_D, d3 - b0);
    float acc[CONV_MAX_D];
#pragma unroll
    for (int k = 0; k < CONV_MAX_D; ++k) acc[k] = 0.f;
    for (int j = j0; j < nj; j += ne) {
      const float* t = tp + j * ts_stride + b0;
      const float* xr = xp + j * xs_stride;
      float y[CONV_MAX_D];
#pragma unroll
      for (int k = 0; k < CONV_MAX_D; ++k) y[k] = 0.f;
      for (int m1 = 0; m1 < d1; ++m1) {
        const float xv = xr[m1];
        const float* tr = t + m1 * d3;
#pragma unroll
        for (int k = 0; k < CONV_MAX_D; ++k)
          if (k < nb) y[k] = fmaf(tr[k], xv, y[k]);
      }
      const float wv = w_at<STAGE_W>(wp, j, dw);
#pragma unroll
      for (int k = 0; k < CONV_MAX_D; ++k) acc[k] = fmaf(wv, y[k], acc[k]);
    }
    for (int off = nu; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < CONV_MAX_D; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (orow) {
#pragma unroll
      for (int k = 0; k < CONV_MAX_D; ++k)
        if (k < nb) orow[b0 + k] = pw * acc[k];
    }
  }
}

// One block per item of at most TE edges; STAGE_W: the item's w rows are
// copied to shared memory (else the lanes read them from global memory);
// ANY_L: the plan has irreps above l = 4.
template <typename T, int TE, bool STAGE_W, bool ANY_L>
__global__ void __launch_bounds__(FWD_THREADS, 1) fused_uvu_conv_fwd_kernel(const FwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts_stride = a.n_t | 1;
  const int xs_stride = a.d1 | 1;
  T* ws = reinterpret_cast<T*>(smem);  // [TE][dw] from ws + w_pad, if STAGE_W
  // [TE][shp], 16-byte aligned
  float* shs = reinterpret_cast<float*>(ws + (STAGE_W ? staged_len<T>((size_t)TE * a.dw) : 0));
  float* ts = shs + TE * a.shp;                    // [TE][ts_stride]
  float* xs = ts + TE * ts_stride;                 // [TE][xs_stride]

  // 1. the item: its destination node (the last n with item_ptr[n] <= item)
  //    and its edges e0 .. e0 + nj - 1. The grid is a bound on the items
  //    (the wrapper's item_bound); a block at or past the real count,
  //    item_ptr[n_out], has no item and writes nothing.
  const int item = blockIdx.x;
  if (item >= __ldg(a.item_ptr + a.n_out)) return;
  int lo = 0, hi = a.n_out;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.item_ptr + mid) <= item) lo = mid; else hi = mid;
  }
  const int e_node = __ldg(a.row_ptr + lo);
  const int e0 = e_node + (item - __ldg(a.item_ptr + lo)) * TE;
  const int nj = min(TE, __ldg(a.row_ptr + lo + 1) - e0);

  // 2. start copying the w rows (contiguous in w) and the x[src] rows; stage
  //    the padded sh rows and contract them with the CG blocks
  const int w_pad = STAGE_W ? cp_async_rows<FWD_THREADS, T>(ws, a.w + (size_t)e0 * a.dw, nj * a.dw) : 0;
  for (int idx = threadIdx.x; idx < nj * a.d1; idx += FWD_THREADS) {
    const int j = idx / a.d1;
    const int c = idx - j * a.d1;
    cp_async4(xs + j * xs_stride + c, a.x + (size_t)__ldg(a.src + e0 + j) * a.d1 + c);
  }
  stage_sh_rows<FWD_THREADS>(shs, a.sh, a.sh_src, e0, nj, a.d2, a.shp);
  __syncthreads();
  contract_te<FWD_THREADS, ANY_L>(ts, ts_stride, shs, a.shp, a.t_meta, a.cg_t, a.t_sh, a.n_t, nj);
  cp_async_wait_all();
  __syncthreads();

  // 3. the warp's tasks: lane = (channel u0 + lane % nu, edges lane / nu,
  //    + ne, ...); idle lanes join the shuffles with zeros
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* prow = a.partial + (size_t)item * a.dout;
  const T* wrows = STAGE_W ? ws + w_pad : a.w + (size_t)e0 * a.dw;
  const int k_end = __ldg(a.warp_ptr + warp + 1);
  for (int k = __ldg(a.warp_ptr + warp); k < k_end; ++k) {
    const int4 tk = __ldg(a.tasks + k);
    const int nu = tk.z >> 16;
    const int ne = tk.w >> 16;
    const int du = lane & (nu - 1);
    const int dj = lane / nu;
    const bool on = du < (tk.w & 0xffff) && dj < ne;
    const int u = (tk.z & 0xffff) + (on ? du : 0);
    const int4 pm = __ldg(a.paths + tk.x);
    const int4 gm = __ldg(a.groups + tk.y);
    const float pw = __ldg(a.path_pw + tk.x);
    const float* tp = ts + pm.y;
    const float* xp = xs + gm.x + u * gm.y;
    const T* wp = wrows + pm.z + u;
    float* orow = on && dj == 0 ? prow + pm.x + u * pm.w : nullptr;
    const int j0 = on ? dj : nj;
    if (ANY_L && (gm.y > CONV_MAX_D || pm.w > CONV_MAX_D)) {  // an irrep above l = 4
      item_path_any<STAGE_W, T>(gm.y, pm.w, tp, ts_stride, xp, xs_stride, wp, a.dw, j0, ne, nj, nu,
                                pw, orow);
      continue;
    }
#define ITEM_PATH(D1) \
  item_path_d3<D1, STAGE_W, T>(pm.w, tp, ts_stride, xp, xs_stride, wp, a.dw, j0, ne, nj, nu, pw, orow)
    switch (gm.y) {  // d1 of the path's input irrep, the same for the whole warp
      case 1: ITEM_PATH(1); break;
      case 3: ITEM_PATH(3); break;
      case 5: ITEM_PATH(5); break;
      case 7: ITEM_PATH(7); break;
      default: ITEM_PATH(9); break;
    }
#undef ITEM_PATH
  }
}

// Shared memory (bytes) one block needs at `in_bytes` (4: float, 2: bf16)
// of sh and w storage, `te` edges per item and the w rows staged or not:
// about 204 KB at the production layer 3 in float at its tier (16 edges,
// w staged), of the 227 KB a block may have. `shp` is the padded sh row
// (TileTables.sh_src). kernels/fused_conv.py::fwd_smem mirrors it.
static size_t fwd_smem(int d1, int shp, int dw, int n_t, int in_bytes, int te, int stage_w) {
  const size_t w_bytes = !stage_w ? 0
      : in_bytes == 2 ? sizeof(__nv_bfloat16) * staged_len<__nv_bfloat16>((size_t)te * dw)
                      : sizeof(float) * staged_len<float>((size_t)te * dw);
  return w_bytes + sizeof(float) * ((size_t)te * shp + (size_t)te * (n_t | 1) + (size_t)te * (d1 | 1));
}

template <typename T, int TE, bool STAGE_W, bool ANY_L>
static int launch_fwd(const FwdArgs<T>& a, int n_items, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_uvu_conv_fwd_kernel<T, TE, STAGE_W, ANY_L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_uvu_conv_fwd_kernel<T, TE, STAGE_W, ANY_L><<<n_items, FWD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool ANY_L>
static int launch_tier(const FwdArgs<T>& a, int n_items, int te, int stage_w, size_t smem,
                       cudaStream_t stream) {
  switch (te * 2 + stage_w) {
    case 33: return launch_fwd<T, 16, true, ANY_L>(a, n_items, smem, stream);
    case 32: return launch_fwd<T, 16, false, ANY_L>(a, n_items, smem, stream);
    case 17: return launch_fwd<T, 8, true, ANY_L>(a, n_items, smem, stream);
    case 16: return launch_fwd<T, 8, false, ANY_L>(a, n_items, smem, stream);
    case 9: return launch_fwd<T, 4, true, ANY_L>(a, n_items, smem, stream);
    case 8: return launch_fwd<T, 4, false, ANY_L>(a, n_items, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_any(const FwdArgs<T>& a, int n_items, int te, int stage_w, int any_l, size_t smem,
                      cudaStream_t stream) {
  return any_l ? launch_tier<T, true>(a, n_items, te, stage_w, smem, stream)
               : launch_tier<T, false>(a, n_items, te, stage_w, smem, stream);
}

template <typename T>
static FwdArgs<T> fwd_args(const float* x, const void* sh, const void* w, const int* src,
                           const int* row_ptr, const int* item_ptr, const void* t_meta,
                           const float* cg_t, const int* t_sh, const int* sh_src,
                           const void* groups, const void* paths, const float* path_pw,
                           const void* tasks, const int* warp_ptr, float* partial, int n_out,
                           int d1, int d2, int shp, int dw, int dout, int n_t) {
  FwdArgs<T> a;
  a.x = x;
  a.sh = static_cast<const T*>(sh);
  a.w = static_cast<const T*>(w);
  a.src = src;
  a.row_ptr = row_ptr;
  a.item_ptr = item_ptr;
  a.t_meta = (const int4*)t_meta;
  a.cg_t = cg_t;
  a.t_sh = t_sh;
  a.sh_src = sh_src;
  a.groups = (const int4*)groups;
  a.paths = (const int4*)paths;
  a.path_pw = path_pw;
  a.tasks = (const int4*)tasks;
  a.warp_ptr = warp_ptr;
  a.partial = partial;
  a.n_out = n_out;
  a.d1 = d1;
  a.d2 = d2;
  a.shp = shp;
  a.dw = dw;
  a.dout = dout;
  a.n_t = n_t;
  return a;
}

extern "C" {

// fwd_smem at a tier (`g_slots` is the backward's and unused here), which
// the wrapper's tier choice reads.
size_t fused_uvu_conv_fwd_smem(int d1, int shp, int dw, int dout, int n_t, int in_bytes,
                               int tile_edges, int stage_w, int g_slots) {
  (void)dout;
  (void)g_slots;
  return fwd_smem(d1, shp, dw, n_t, in_bytes, tile_edges, stage_w);
}

// Launches `n_items` blocks on `stream`, a bound on the items (the real
// count, item_ptr[n_out], is read on the device, so the launch never waits
// for it and can be captured in a CUDA graph); allocates nothing. sh and w are
// float (`in_bytes` 4) or bf16 (`in_bytes` 2). The tier: `tile_edges` edges
// per item (16, 8 or 4; the wrapper's item_ptr and task table are built
// for it) and `stage_w` (1: the w rows staged in shared memory); `any_l`
// (1: the plan has an irrep above l = 4, whose paths take the generic
// code); `warps` must match this build's. Returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for another tier or a block
// that would need more shared memory than the device's opt-in limit.
int fused_uvu_conv_fwd(const float* x, const void* sh, const void* w, const int* src,
                       const int* row_ptr, const int* item_ptr, const void* t_meta,
                       const float* cg_t, const int* t_sh, const int* sh_src,
                       const void* groups, const void* paths, const float* path_pw,
                       const void* tasks, const int* warp_ptr, float* partial, int n_items,
                       int n_out, int d1, int d2, int shp, int dw, int dout, int n_t,
                       int in_bytes, int tile_edges, int stage_w, int any_l, int warps, void* stream) {
  if (warps != FWD_WARPS || shp % 4 || (in_bytes != 4 && in_bytes != 2) || (stage_w != 0 && stage_w != 1))
    return (int)cudaErrorInvalidValue;
  if (n_items == 0) return 0;  // no edges: the wrapper's bound is 0
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_smem(d1, shp, dw, n_t, in_bytes, tile_edges, stage_w);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (in_bytes == 2)
    return launch_any(fwd_args<__nv_bfloat16>(x, sh, w, src, row_ptr, item_ptr, t_meta, cg_t, t_sh,
                                               sh_src, groups, paths, path_pw, tasks, warp_ptr,
                                               partial, n_out, d1, d2, shp, dw, dout, n_t),
                      n_items, tile_edges, stage_w, any_l, smem, (cudaStream_t)stream);
  return launch_any(fwd_args<float>(x, sh, w, src, row_ptr, item_ptr, t_meta, cg_t, t_sh, sh_src,
                                    groups, paths, path_pw, tasks, warp_ptr, partial, n_out, d1,
                                    d2, shp, dw, dout, n_t),
                    n_items, tile_edges, stage_w, any_l, smem, (cudaStream_t)stream);
}

}  // extern "C"
