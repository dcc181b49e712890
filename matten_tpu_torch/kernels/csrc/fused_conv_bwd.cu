// Fused uvu tensor-product convolution, backward, for Hopper (sm_90a): the
// merged dx + dw pass `fused_uvu_conv_bwd` over tiles of edges. Its per-edge
// dx rows are summed into the sources by segment_sum.cu.
//
// Replaces the gradient kernels of matten_tpu/kernels/fused_conv.py: the
// merged backward `_build_bwd2` (K2), and, beyond the JAX package's
// 2048-node limit, the transposed `_build_call` over a src-sorted
// permutation (K3's dx role) and `_build_dw_call` (K4). With the forward of
// fused_conv.cu,
//
//   out[n, o] = pw[o] * sum_{e : dst[e] = n} w[e, w_idx(o)]
//               * sum_{m1} t_e[t_idx(o) + m1 * d3(o)] * x[src[e], x_idx(o) + m1]
//   t_e[i]    = sum_{m2} C_i[m2] * sh[e, sh_off(i) + m2],
//
// and g = d loss / d out, weight k = (path p, channel u) of input irrep i,
// with G = g[dst[e], o_base(k) : o_base(k) + d3], gives
//
//   Y[m1]                     = sum_{m3} t_e[t_off(p) + m1 * d3 + m3] * G[m3]
//   dw[e, k]                  = pw_p * sum_{m1} x[src[e], x_base(i, u) + m1] * Y[m1]
//   dxe[e, x_base(i, u) + m1] = sum_{p of irrep i} pw_p * w[e, k] * Y[m1]
//   dx[n]                     = sum_{e : src[e] = n} dxe[e]
//
// Y is shared by both gradients, so one pass computes it once per (edge,
// weight), as the TPU kernel builds its per-block dwT and dx messages from
// one contraction before it scatters the messages into the sources.
//
// Design.
// * Work unit: a tile of TE = 16 consecutive dst-sorted edges per block,
//   ceil(E / 16) blocks (1344 on the flagship batch): every block does about
//   the same work, whatever the degree of the nodes.
// * Ownership without atomics: one lane owns one (input channel (i, u),
//   edge) pair. It walks every path of irrep i, writes dw[e, k] once per
//   path, keeps the channel's d1 dx values in registers and writes them once
//   to the per-edge scratch dxe [E, d1]. segment_sum.cu sums the dxe rows
//   of each source node over a stable argsort of src, in edge order. No two
//   lanes write one address and every sum has a fixed order, so dx and dw
//   are bitwise reproducible.
// * The lanes of a warp hold channels u of ONE irrep (consecutive u, then
//   the next edge): they run the same paths with the same d1 and d3, so the
//   warp never diverges, and they read w and write dw at consecutive
//   addresses (w_off(p) + u). Per-plan tables
//   (built by the Python wrapper from the forward's): for each input irrep
//   its x offset, d1 and path range; for each path (o_off, t_off, w_off, d3)
//   and pw, so channel u reads o_off + u * d3, w_off + u and x_off + u * d1;
//   and the warp tasks (irrep, u range, edge range), dealt to the block's
//   24 warps heaviest first, each to the least loaded warp.
// * Shared memory per block: t_e of the tile [16][n_t | 1] (an odd row
//   stride: lanes of different edges hit different banks, lanes of one edge
//   read one address), the tile's sh rows with each irrep padded to 4
//   floats (so the t_e contraction reads them 16 bytes at a time), the g
//   rows of the tile's first g_slots = 2 destinations (a tile of the
//   flagship batch, mean degree 74, spans 1-2; edges of further
//   destinations, as on degree-1 nodes or sparse random graphs, read g
//   through the cache), and the tile's w rows (contiguous in w, 16 * dw
//   floats). At the production layer 3 (n_t 2067, dout 4170, dw 842) that
//   is 132 + 2 + 33 + 54 KB: one block per SM, so 24 warps (768 threads, at
//   most 85 registers each) are what hides latency. Where w does not fit
//   beside the rest it is read from global memory, coalesced across u all
//   the same.
// * Tiers: where even that does not fit (wider multiplicities, sh irreps
//   above l = 4), a smaller instance of the same kernel runs: fewer g slots
//   (down to none: every g row read through the cache), then tiles of 8
//   or 4 edges. The wrapper picks the first tier that fits per plan
//   (fused_conv.py::choose_tiers) and deals the tasks for its tile size;
//   every production plan runs the first, 16 edges and 2 g slots.
// * Asynchronous copies: the w rows are copied with 16-byte cp.async as the
//   block starts and the g rows with 4-byte cp.async (a g row is only
//   4-byte aligned) while the block contracts t_e, so neither stalls the
//   lanes, whose only global loads are then x (d1 floats once per task).
//   The contraction Y is unrolled for each (d1, d3), so all of a path's
//   shared-memory loads are in flight together. dw and dxe are stored from
//   the lanes: consecutive u write consecutive dw addresses.
// * Irreps above l = 4 (d1, or the d3 of one of the irrep's paths, > 9)
//   take one generic path: d1 and d3 read at run time, the channel's d1
//   values in blocks of at most CONV_MAX_D registers (x, Y and dx), each
//   block a pass over the irrep's paths whose dw partial sums the lane adds
//   into its own dw entries. It is compiled only into the ANY_L instances,
//   which the wrapper launches for a plan with an irrep above l = 4; the
//   unrolled (d1, d3) paths of l <= 4 are the production ones. Whether the
//   w rows are staged is a template parameter too (STAGE_W), so the
//   production instance reads them from shared memory by address space.
// * float32 on the CUDA cores: the contractions are d1, d3 <= 9 deep (11
//   at l = 5) with a different CG product per edge, far below wgmma's
//   64-row tiles, and TF32 would break the 1e-5 parity the checks hold.
// * Storage of sh and w: float or bf16 (a template over T; the JAX kernels'
//   `set_kernel_in_dtype`). At bf16 the tile's w rows are staged at 2 bytes
//   and widened where a lane reads them, sh is widened as it is staged; x,
//   g, the arithmetic, dw and the dxe rows stay float32.
//
// What bounds it on an H100: the function's inputs read once and its outputs
// (dx, dw) written once are about 153 MB at the production layer 3 (w and dw,
// 72 MB each, dominate), 46 us at 3.35 TB/s; its float32 work, about 35k
// multiply-adds per edge (t_e 12k, Y 13k, dw and dx 9k), is 1.5 GFLOP,
// 22 us at 67 TFLOP/s. The kernel also writes and the reduction reads the
// dxe scratch (21 MB there). It runs its phases one after the other in a
// block (staging, t_e, the tasks), with one block per SM, and every
// multiply-add of Y reads an operand from shared memory: at layer 3 it
// takes about 5x its bound (conv_bwd_phases.py splits the time by phase).

#include "fused_conv_common.cuh"

#define BWD_WARPS 24
#define BWD_THREADS (32 * BWD_WARPS)
#define BWD_MAX_GSLOTS 2             // destinations per tile with a staged g row, at most

template <typename T>
struct BwdArgs {
  const float* x;          // [n_in, d1]
  const float* g;          // [n_out, dout]
  const T* sh;             // [E, d2]
  const T* w;              // [E, dw]
  const int* src;          // [E]
  const int* dst;          // [E], non-decreasing
  const int4* t_meta;      // [n_t]: cg offset, sh offset, d2_i, 0
  const float* cg_t;       // [rows, n_t]: C_i[m2] at m2 * n_t + i, 0 past d2_i
  const int* t_sh;         // [n_t]: offset of entry i's sh segment in a padded sh row
  const int* sh_src;       // [shp]: sh component of each padded slot, or -1
  const int4* groups;      // [irreps of in1]: x_off, d1, path begin, path end
  const int4* paths;       // [paths]: o_off, t_off, w_off, d3
  const float* path_pw;    // [paths]
  // u0 | nu << 16, group, u count | generic << 16, j0 | ne << 16 (generic:
  // the irrep's d1 or a path's d3 is above CONV_MAX_D)
  const int4* tasks;
  const int* warp_ptr;     // [BWD_WARPS + 1] offsets of each warp's tasks
  float* dw_out;           // [E, dw], or null: dw not wanted
  float* dxe;              // [E, d1], or null: dx not wanted
  int n_edges, d1, d2, shp, dw, dout, n_t;
  int g_slots;             // destinations per tile with a staged g row, 0 .. BWD_MAX_GSLOTS
};

// Y[m1] = sum_{m3} t[m1 * D3 + m3] * G[m3] of one path: fully unrolled, so
// all D1 * D3 shared-memory loads are in flight together
template <int D1, int D3>
static __device__ __forceinline__ void path_y(const float* tp, const float* gp, float (&y)[D1]) {
  float gv[D3];
#pragma unroll
  for (int m3 = 0; m3 < D3; ++m3) gv[m3] = gp[m3];
#pragma unroll
  for (int m1 = 0; m1 < D1; ++m1) {
    float s = 0.f;
#pragma unroll
    for (int m3 = 0; m3 < D3; ++m3) s = fmaf(tp[m1 * D3 + m3], gv[m3], s);
    y[m1] = s;
  }
}

// One lane's (channel, edge) pair over every path of the channel's irrep.
// xrow, wrow, dwrow and drow point at the channel's entries of the edge
// (dwrow, drow null when that gradient is not wanted); grow at g[dst].
template <int D1, typename T>
static __device__ __forceinline__ void channel_edge(
    const int4* __restrict__ paths, const float* __restrict__ path_pw, const float* trow,
    const float* grow, const float* xrow, const T* wrow, float* dwrow, float* drow,
    int u, int q_begin, int q_end) {
  float xv[D1], dxv[D1];
#pragma unroll
  for (int m1 = 0; m1 < D1; ++m1) {
    xv[m1] = dwrow ? __ldg(xrow + m1) : 0.f;
    dxv[m1] = 0.f;
  }
  int4 pm_next = q_begin < q_end ? __ldg(paths + q_begin) : make_int4(0, 0, 0, 1);
  float pw_next = q_begin < q_end ? __ldg(path_pw + q_begin) : 0.f;
  for (int q = q_begin; q < q_end; ++q) {
    const int4 pm = pm_next;
    const float pw = pw_next;
    if (q + 1 < q_end) {  // the next path's entries load while this one computes
      pm_next = __ldg(paths + q + 1);
      pw_next = __ldg(path_pw + q + 1);
    }
    const float* gp = grow + pm.x + u * pm.w;
    const float* tp = trow + pm.y;
    float y[D1];
    switch (pm.w) {  // d3 of the path, the same for the whole warp
      case 1: path_y<D1, 1>(tp, gp, y); break;
      case 3: path_y<D1, 3>(tp, gp, y); break;
      case 5: path_y<D1, 5>(tp, gp, y); break;
      case 7: path_y<D1, 7>(tp, gp, y); break;
      default: path_y<D1, 9>(tp, gp, y); break;  // d3 <= CONV_MAX_D here
    }
    if (dwrow) {
      float s = 0.f;
#pragma unroll
      for (int m1 = 0; m1 < D1; ++m1) s = fmaf(xv[m1], y[m1], s);
      dwrow[pm.z] = pw * s;
    }
    if (drow) {
      const float wv = pw * to_f32(wrow[pm.z]);
#pragma unroll
      for (int m1 = 0; m1 < D1; ++m1) dxv[m1] = fmaf(wv, y[m1], dxv[m1]);
    }
  }
  if (drow) {
#pragma unroll
    for (int m1 = 0; m1 < D1; ++m1) drow[m1] = dxv[m1];
  }
}

// channel_edge for any d1 and d3 (an irrep above l = 4, or one with a
// path to an output above l = 4): the channel's m1 in blocks of CONV_MAX_D,
// each block a pass over the irrep's paths with x, Y and dx of the block in
// registers; dw[e, k] = pw_p sum_{m1} x Y is written by the first block and
// added to by the later ones (the lane owns the entry), and each block's
// dx values are written once.
template <typename T>
static __device__ __forceinline__ void channel_edge_any(
    const int4* __restrict__ paths, const float* __restrict__ path_pw, const float* trow,
    const float* grow, const float* xrow, const T* wrow, float* dwrow, float* drow,
    int d1, int u, int q_begin, int q_end) {
  for (int b0 = 0; b0 < d1; b0 += CONV_MAX_D) {
    const int nb = min(CONV_MAX_D, d1 - b0);
    float xv[CONV_MAX_D], dxv[CONV_MAX_D];
#pragma unroll
    for (int k = 0; k < CONV_MAX_D; ++k) {
      xv[k] = dwrow && k < nb ? __ldg(xrow + b0 + k) : 0.f;
      dxv[k] = 0.f;
    }
    for (int q = q_begin; q < q_end; ++q) {
      const int4 pm = __ldg(paths + q);
      const float pw = __ldg(path_pw + q);
      const int d3 = pm.w;
      const float* gp = grow + pm.x + u * d3;
      const float* tp = trow + pm.y + b0 * d3;
      float y[CONV_MAX_D];
#pragma unroll
      for (int k = 0; k < CONV_MAX_D; ++k) y[k] = 0.f;
      for (int m3 = 0; m3 < d3; ++m3) {
        const float gv = gp[m3];
#pragma unroll
        for (int k = 0; k < CONV_MAX_D; ++k)
          if (k < nb) y[k] = fmaf(tp[k * d3 + m3], gv, y[k]);
      }
      if (dwrow) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < CONV_MAX_D; ++k) s = fmaf(xv[k], y[k], s);
        dwrow[pm.z] = b0 ? dwrow[pm.z] + pw * s : pw * s;
      }
      if (drow) {
        const float wv = pw * to_f32(wrow[pm.z]);
#pragma unroll
        for (int k = 0; k < CONV_MAX_D; ++k) dxv[k] = fmaf(wv, y[k], dxv[k]);
      }
    }
    if (drow) {
#pragma unroll
      for (int k = 0; k < CONV_MAX_D; ++k)
        if (k < nb) drow[b0 + k] = dxv[k];
    }
  }
}

// One block per tile of at most TE edges; STAGE_W: the tile's w rows are
// copied to shared memory (else the lanes read them from global memory);
// ANY_L: the plan has irreps above l = 4.
template <typename T, int TE, bool STAGE_W, bool ANY_L>
__global__ void __launch_bounds__(BWD_THREADS, 1) fused_uvu_conv_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts_stride = a.n_t | 1;
  T* ws = reinterpret_cast<T*>(smem);  // [TE][dw] from ws + w_pad, if STAGE_W
  // [TE][shp], 16-byte aligned
  float* shs = reinterpret_cast<float*>(ws + (STAGE_W ? staged_len<T>((size_t)TE * a.dw) : 0));
  float* ts = shs + TE * a.shp;                       // [TE][ts_stride]
  float* gs = ts + TE * ts_stride;                    // [g_slots][dout]
  int* src_s = reinterpret_cast<int*>(gs + a.g_slots * a.dout);  // [TE]
  int* dst_s = src_s + TE;                            // [TE]
  int* slot_s = dst_s + TE;                           // [TE]: g slot, or -1
  int* slot_node = slot_s + TE;                       // [g_slots]
  int* n_slots = slot_node + a.g_slots;               // [1]

  const int tid = threadIdx.x;
  const int tile0 = blockIdx.x * TE;
  const int nj = min(TE, a.n_edges - tile0);

  // 1. start copying the tile's w rows (contiguous, nj * dw floats); load
  //    the edge ends and the padded sh rows
  const int w_pad = STAGE_W ? cp_async_rows<BWD_THREADS, T>(ws, a.w + (size_t)tile0 * a.dw, nj * a.dw) : 0;
  if (tid < TE) {
    src_s[tid] = tid < nj ? a.src[tile0 + tid] : 0;
    dst_s[tid] = tid < nj ? a.dst[tile0 + tid] : -1;
  }
  stage_sh_rows<BWD_THREADS>(shs, a.sh, a.sh_src, tile0, nj, a.d2, a.shp);
  __syncthreads();

  // 2. destinations: edge j lies in the run-th run of equal dst; the first
  //    g_slots runs get a staged g row, later ones read g from the cache
  if (tid < nj) {
    int run = 0;
    for (int k = 1; k <= tid; ++k) run += dst_s[k] != dst_s[k - 1];
    slot_s[tid] = run < a.g_slots ? run : -1;
    if (run < a.g_slots && (tid == 0 || dst_s[tid] != dst_s[tid - 1])) slot_node[run] = dst_s[tid];
    if (tid == nj - 1) *n_slots = min(run + 1, a.g_slots);
  }
  __syncthreads();

  // 3. copy the g rows, and meanwhile contract the CG blocks with sh:
  //    ts[j][i] = t_e[i]
  const int ns = *n_slots;
  for (int idx = tid; idx < ns * a.dout; idx += BWD_THREADS) {
    const int s = idx / a.dout;
    cp_async4(gs + idx, a.g + (size_t)slot_node[s] * a.dout + (idx - s * a.dout));
  }
  contract_te<BWD_THREADS, ANY_L>(ts, ts_stride, shs, a.shp, a.t_meta, a.cg_t, a.t_sh, a.n_t, nj);
  cp_async_wait_all();
  __syncthreads();

  // 4. the warp's tasks: lane = (u0 + lane % nu, j0 + lane / nu)
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k_end = __ldg(a.warp_ptr + warp + 1);
  for (int k = __ldg(a.warp_ptr + warp); k < k_end; ++k) {
    const int4 tk = __ldg(a.tasks + k);
    const int nu = tk.x >> 16;
    const int du = lane % nu;
    const int dj = lane / nu;
    const int j = (tk.w & 0xffff) + dj;
    if (du >= (tk.z & 0xffff) || dj >= (tk.w >> 16) || j >= nj) continue;
    const int u = (tk.x & 0xffff) + du;
    const int e = tile0 + j;
    const int4 gm = __ldg(a.groups + tk.y);
    const int xb = gm.x + u * gm.y;
    const int sl = slot_s[j];
    const float* grow = sl >= 0 ? gs + sl * a.dout : a.g + (size_t)dst_s[j] * a.dout;
    const float* trow = ts + j * ts_stride;
    const float* xrow = a.x + (size_t)src_s[j] * a.d1 + xb;
    const T* wrow = (STAGE_W ? ws + w_pad + j * a.dw : a.w + (size_t)e * a.dw) + u;
    float* dwrow = a.dw_out ? a.dw_out + (size_t)e * a.dw + u : nullptr;
    float* drow = a.dxe ? a.dxe + (size_t)e * a.d1 + xb : nullptr;
    if (ANY_L && (tk.z >> 16)) {  // an irrep above l = 4, or with a path to one
      channel_edge_any<T>(a.paths, a.path_pw, trow, grow, xrow, wrow, dwrow, drow, gm.y, u, gm.z, gm.w);
      continue;
    }
#define CHANNEL_EDGE(D1)                                                                  \
  channel_edge<D1, T>(a.paths, a.path_pw, trow, grow, xrow, wrow, dwrow, drow, u, gm.z, gm.w)
    switch (gm.y) {  // d1 of the irrep, the same for the whole warp
      case 1: CHANNEL_EDGE(1); break;
      case 3: CHANNEL_EDGE(3); break;
      case 5: CHANNEL_EDGE(5); break;
      case 7: CHANNEL_EDGE(7); break;
      default: CHANNEL_EDGE(9); break;
    }
#undef CHANNEL_EDGE
  }
}

// Shared memory (bytes) one block of the merged kernel needs at a tier:
// `te` edges per tile, `g_slots` staged g rows, and the tile's w rows at
// `in_bytes` (4: float, 2: bf16) of storage when `stage_w` (217 KB at the
// production layer 3 in float at its tier: 16 edges, 2 slots, w staged).
// `shp` is the padded sh row (TileTables.sh_src).
// kernels/fused_conv.py::bwd_smem mirrors it.
static size_t bwd_smem(int shp, int dw, int dout, int n_t, int in_bytes, int te, int stage_w, int g_slots) {
  const size_t w_bytes = !stage_w ? 0
      : in_bytes == 2 ? sizeof(__nv_bfloat16) * staged_len<__nv_bfloat16>((size_t)te * dw)
                      : sizeof(float) * staged_len<float>((size_t)te * dw);
  return w_bytes + sizeof(float) * ((size_t)te * (n_t | 1) + (size_t)g_slots * dout + (size_t)te * shp) +
         sizeof(int) * (3 * te + g_slots + 1);
}

template <typename T, int TE, bool STAGE_W, bool ANY_L>
static int launch_bwd(const BwdArgs<T>& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_uvu_conv_bwd_kernel<T, TE, STAGE_W, ANY_L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_uvu_conv_bwd_kernel<T, TE, STAGE_W, ANY_L><<<(a.n_edges + TE - 1) / TE, BWD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool ANY_L>
static int launch_edges(const BwdArgs<T>& a, int te, int stage_w, size_t smem, cudaStream_t stream) {
  switch (te * 2 + stage_w) {
    case 33: return launch_bwd<T, 16, true, ANY_L>(a, smem, stream);
    case 32: return launch_bwd<T, 16, false, ANY_L>(a, smem, stream);
    case 17: return launch_bwd<T, 8, true, ANY_L>(a, smem, stream);
    case 16: return launch_bwd<T, 8, false, ANY_L>(a, smem, stream);
    case 9: return launch_bwd<T, 4, true, ANY_L>(a, smem, stream);
    case 8: return launch_bwd<T, 4, false, ANY_L>(a, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_tier(const float* x, const float* g, const void* sh, const void* w,
                       const int* src, const int* dst, const void* t_meta, const float* cg_t,
                       const int* t_sh, const int* sh_src, const void* groups, const void* paths,
                       const float* path_pw, const void* tasks, const int* warp_ptr,
                       float* dw_out, float* dxe, int n_edges, int d1, int d2, int shp, int dw,
                       int dout, int n_t, int te, int stage_w, int g_slots, int any_l, size_t smem,
                       cudaStream_t stream) {
  BwdArgs<T> a;
  a.x = x;
  a.g = g;
  a.sh = static_cast<const T*>(sh);
  a.w = static_cast<const T*>(w);
  a.src = src;
  a.dst = dst;
  a.t_meta = (const int4*)t_meta;
  a.cg_t = cg_t;
  a.t_sh = t_sh;
  a.sh_src = sh_src;
  a.groups = (const int4*)groups;
  a.paths = (const int4*)paths;
  a.path_pw = path_pw;
  a.tasks = (const int4*)tasks;
  a.warp_ptr = warp_ptr;
  a.dw_out = dw_out;
  a.dxe = dxe;
  a.n_edges = n_edges;
  a.d1 = d1;
  a.d2 = d2;
  a.shp = shp;
  a.dw = dw;
  a.dout = dout;
  a.n_t = n_t;
  a.g_slots = g_slots;
  return any_l ? launch_edges<T, true>(a, te, stage_w, smem, stream)
               : launch_edges<T, false>(a, te, stage_w, smem, stream);
}

extern "C" {

// bwd_smem at a tier (`d1` unused), which the wrapper's tier choice reads.
size_t fused_uvu_conv_bwd_smem(int d1, int shp, int dw, int dout, int n_t, int in_bytes,
                               int tile_edges, int stage_w, int g_slots) {
  (void)d1;
  return bwd_smem(shp, dw, dout, n_t, in_bytes, tile_edges, stage_w, g_slots);
}

// Launches on `stream`, allocates nothing and returns the cudaError_t of
// the launch (0 on success). sh and w are float (`in_bytes` 4) or bf16
// (`in_bytes` 2). The tier: `tile_edges` edges per tile (16, 8 or 4; the
// wrapper's task table is built for it), `stage_w` (1: the tile's w rows
// staged in shared memory, which only dx reads) and `g_slots` (0 to 2);
// `any_l` (1: the plan has an irrep above l = 4, whose paths take the
// generic code); `warps` must match this build's. cudaErrorInvalidValue for
// another tier or a block that would need more shared memory than the
// device's opt-in limit.
int fused_uvu_conv_bwd(const float* x, const float* g, const void* sh, const void* w,
                       const int* src, const int* dst, const void* t_meta,
                       const float* cg_t, const int* t_sh, const int* sh_src,
                       const void* groups, const void* paths, const float* path_pw,
                       const void* tasks, const int* warp_ptr, float* dw_out, float* dxe,
                       int n_edges, int d1, int d2, int shp, int dw, int dout, int n_t,
                       int in_bytes, int tile_edges, int stage_w, int g_slots, int any_l,
                       int warps, void* stream) {
  if (warps != BWD_WARPS || shp % 4 || (in_bytes != 4 && in_bytes != 2) ||
      (stage_w != 0 && stage_w != 1) || g_slots < 0 || g_slots > BWD_MAX_GSLOTS)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem(shp, dw, dout, n_t, in_bytes, tile_edges, stage_w, g_slots);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return in_bytes == 2
      ? launch_tier<__nv_bfloat16>(x, g, sh, w, src, dst, t_meta, cg_t, t_sh, sh_src, groups,
                                   paths, path_pw, tasks, warp_ptr, dw_out, dxe, n_edges, d1, d2,
                                   shp, dw, dout, n_t, tile_edges, stage_w, g_slots, any_l, smem,
                                   (cudaStream_t)stream)
      : launch_tier<float>(x, g, sh, w, src, dst, t_meta, cg_t, t_sh, sh_src, groups, paths,
                           path_pw, tasks, warp_ptr, dw_out, dxe, n_edges, d1, d2, shp, dw, dout,
                           n_t, tile_edges, stage_w, g_slots, any_l, smem, (cudaStream_t)stream);
}

}  // extern "C"
