// Fused uvu tensor-product convolution, backward (dx and dw), for Hopper
// (sm_90a).
//
// Replaces the gradient kernels of matten_tpu/kernels/fused_conv.py: the
// merged dx + dw pass `_build_bwd2` (K2), the transposed `_build_call` that
// computes dx over a src-sorted permutation (K3's backward role) and the
// per-edge weight gradient `_build_dw_call` (K4). With the forward of
// fused_conv.cu,
//
//   out[n, o] = pw[o] * sum_{e : dst[e] = n} w[e, w_idx(o)]
//               * sum_{m1} t_e[t_idx(o) + m1 * d3(o)] * x[src[e], x_idx(o) + m1]
//   t_e[i]    = sum_{m2} C_i[m2] * sh[e, sh_off(i) + m2],
//
// and g = d loss / d out, the two gradients are
//
//   dx[n, c]  = sum_{e : src[e] = n} sum_{(p, u) reading c}
//               sum_{m3} gw_e[o_base(p, u) + m3] * t_e[t_base(p, u, c) + m3]
//   gw_e[o]   = pw[o] * g[dst[e], o] * w[e, w_idx(o)]
//
//   dw[e, k]  = sum_{m3} pw * g[dst[e], o_base(k) + m3]
//               * sum_{m1} t_e[t_off(k) + m1 * d3(k) + m3] * x[src[e], x_base(k) + m1]
//
// where k = (p, u) runs over the plan's weights and c over the input
// components. The per-plan tables (built once per plan by the Python
// wrapper from the forward's tables) are:
//   dx_ptr [d1 + 1], dx_meta [n_dx]: o_base, t_base, d3, 0 -- for each input
//     component c, the (path, channel) pairs whose messages read it, the
//     transposed form of the forward's out_meta;
//   dw_meta [dw]: x_base, t_off, o_base, d1 | d3 << 16.
//
// Design. Both kernels follow the forward's deterministic walk: one thread
// block owns one output row and is the only writer of it, so there are no
// atomics and the summation order is fixed.
//   dx: one block per SOURCE node, over the edges sorted by source (the
//     wrapper passes a stable argsort of src and its CSR offsets). Per edge
//     it stages gw_e (the cotangent row of the destination times the edge's
//     weights and path weights) and t_e in shared memory; each thread owns
//     input components and adds their products to a shared accumulator.
//   dw: one block per DESTINATION node, over the dst-sorted edges (the
//     forward's CSR). The node's cotangent row g[n] times the path weights is
//     staged once; per edge x[src] and t_e are staged, and each thread owns
//     weights (p, u) and writes dw[e, k] once.
// The TPU kernel merges the two passes and scatters dx into src with
// one-hot matmuls; on the GPU that scatter would need atomics, so the two
// gradients are separate passes here.
//
// What bounds them on an H100: each input read once and each output written
// once is about 80 MB at the production layer 3 (w [E, dw] and the edge
// arrays dominate), and the arithmetic about as many float32 multiply-adds
// as the forward's (1.3 GFLOP there), about 24 us at the card's peak either
// way. These first kernels are bound instead by one block per node (2.4
// blocks per SM on the flagship batch, the highest-degree node setting the
// time) and by shared-memory bandwidth; splitting nodes across blocks and
// tensor cores are later work.

#include <stdint.h>

#include "fused_conv_common.cuh"

__global__ void __launch_bounds__(THREADS) fused_uvu_conv_dx_kernel(
    const float* __restrict__ g,         // [n_out, dout]
    const float* __restrict__ sh,        // [E, d2]
    const float* __restrict__ w,         // [E, dw]
    const int* __restrict__ dst,         // [E]
    const int* __restrict__ perm,        // [E] edge ids sorted by src
    const int* __restrict__ row_ptr,     // [n_in + 1] offsets into perm
    const int4* __restrict__ t_meta,     // [n_t]: cg_off, sh_off, d2_i, 0
    const float* __restrict__ cg,
    const int4* __restrict__ out_meta,   // [dout]: x_idx, t_idx, w_idx, d1 | d3 << 16
    const float* __restrict__ out_pw,    // [dout]
    const int* __restrict__ dx_ptr,      // [d1 + 1]
    const int4* __restrict__ dx_meta,    // [n_dx]: o_base, t_base, d3, 0
    float* __restrict__ dx,              // [n_in, d1]
    int d1, int d2, int dw, int dout, int n_t) {
  extern __shared__ float smem[];
  float* acc = smem;                               // [d1]
  float* gws = acc + d1;                           // [EDGES_PER_STAGE, dout]
  float* shs = gws + EDGES_PER_STAGE * dout;       // [EDGES_PER_STAGE, d2]
  float* ts = shs + EDGES_PER_STAGE * d2;          // [EDGES_PER_STAGE, n_t]

  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  const int k_begin = row_ptr[node];
  const int k_end = row_ptr[node + 1];

  for (int c = tid; c < d1; c += THREADS) acc[c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += EDGES_PER_STAGE) {
    const int nj = min(EDGES_PER_STAGE, k_end - k0);

    for (int j = 0; j < nj; ++j) {
      const int e = perm[k0 + j];
      const float* grow = g + (size_t)dst[e] * dout;
      const float* wrow = w + (size_t)e * dw;
      const float* shrow = sh + (size_t)e * d2;
      for (int o = tid; o < dout; o += THREADS) {
        const int w_idx = __ldg(&out_meta[o].z);
        gws[j * dout + o] = __ldg(out_pw + o) * grow[o] * wrow[w_idx];
      }
      for (int c = tid; c < d2; c += THREADS) shs[j * d2 + c] = shrow[c];
    }
    __syncthreads();

    contract_sh(shs, ts, t_meta, cg, nj, d2, n_t);
    __syncthreads();

    // each thread owns input components c = tid + k * THREADS
    for (int c = tid; c < d1; c += THREADS) {
      const int q_begin = __ldg(dx_ptr + c);
      const int q_end = __ldg(dx_ptr + c + 1);
      float a = acc[c];
      for (int j = 0; j < nj; ++j) {
        for (int q = q_begin; q < q_end; ++q) {
          const int4 dm = __ldg(dx_meta + q);
          const float* gg = gws + j * dout + dm.x;
          const float* tt = ts + j * n_t + dm.y;
          for (int m3 = 0; m3 < dm.z; ++m3) a = fmaf(gg[m3], tt[m3], a);
        }
      }
      acc[c] = a;
    }
    __syncthreads();
  }

  float* row = dx + (size_t)node * d1;
  for (int c = tid; c < d1; c += THREADS) row[c] = acc[c];
}

__global__ void __launch_bounds__(THREADS) fused_uvu_conv_dw_kernel(
    const float* __restrict__ x,         // [n_in, d1]
    const float* __restrict__ g,         // [n_out, dout]
    const float* __restrict__ sh,        // [E, d2]
    const int* __restrict__ src,         // [E]
    const int* __restrict__ row_ptr,     // [n_out + 1] offsets of the dst-sorted edges
    const int4* __restrict__ t_meta,
    const float* __restrict__ cg,
    const float* __restrict__ out_pw,    // [dout]
    const int4* __restrict__ dw_meta,    // [dw]: x_base, t_off, o_base, d1 | d3 << 16
    float* __restrict__ dw_out,          // [E, dw]
    int d1, int d2, int dw, int dout, int n_t) {
  extern __shared__ float smem[];
  float* gp = smem;                                // [dout]
  float* xs = gp + dout;                           // [EDGES_PER_STAGE, d1]
  float* shs = xs + EDGES_PER_STAGE * d1;          // [EDGES_PER_STAGE, d2]
  float* ts = shs + EDGES_PER_STAGE * d2;          // [EDGES_PER_STAGE, n_t]

  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  const int e_begin = row_ptr[node];
  const int e_end = row_ptr[node + 1];
  if (e_begin == e_end) return;

  const float* grow = g + (size_t)node * dout;
  for (int o = tid; o < dout; o += THREADS) gp[o] = __ldg(out_pw + o) * grow[o];

  for (int e0 = e_begin; e0 < e_end; e0 += EDGES_PER_STAGE) {
    const int nj = min(EDGES_PER_STAGE, e_end - e0);

    for (int j = 0; j < nj; ++j) {
      const int e = e0 + j;
      const float* xrow = x + (size_t)src[e] * d1;
      const float* shrow = sh + (size_t)e * d2;
      for (int c = tid; c < d1; c += THREADS) xs[j * d1 + c] = xrow[c];
      for (int c = tid; c < d2; c += THREADS) shs[j * d2 + c] = shrow[c];
    }
    __syncthreads();

    contract_sh(shs, ts, t_meta, cg, nj, d2, n_t);
    __syncthreads();

    // each thread owns weights k = tid + i * THREADS
    for (int k = tid; k < dw; k += THREADS) {
      const int4 wm = __ldg(dw_meta + k);
      const int pd1 = wm.w & 0xffff;
      const int pd3 = wm.w >> 16;
      for (int j = 0; j < nj; ++j) {
        const float* t = ts + j * n_t + wm.y;
        const float* xu = xs + j * d1 + wm.x;
        float s = 0.f;
        for (int m3 = 0; m3 < pd3; ++m3) {
          float a = 0.f;
          for (int m1 = 0; m1 < pd1; ++m1) a = fmaf(t[m1 * pd3 + m3], xu[m1], a);
          s = fmaf(gp[wm.z + m3], a, s);
        }
        dw_out[(size_t)(e0 + j) * dw + k] = s;
      }
    }
    __syncthreads();
  }
}

extern "C" {

// Shared memory (bytes) one block of each kernel needs; the wrapper names it
// when a launch fails.
size_t fused_uvu_conv_dx_smem(int d1, int d2, int dw, int dout, int n_t) {
  return sizeof(float) *
         ((size_t)d1 + (size_t)EDGES_PER_STAGE * ((size_t)dout + d2 + n_t));
}

size_t fused_uvu_conv_dw_smem(int d1, int d2, int dw, int dout, int n_t) {
  return sizeof(float) *
         ((size_t)dout + (size_t)EDGES_PER_STAGE * ((size_t)d1 + d2 + n_t));
}

// Both launch on `stream`, allocate nothing and return the cudaError_t of
// the launch (0 on success).
int fused_uvu_conv_dx(const float* g, const float* sh, const float* w,
                      const int* dst, const int* perm, const int* row_ptr,
                      const void* t_meta, const float* cg, const void* out_meta,
                      const float* out_pw, const int* dx_ptr, const void* dx_meta,
                      float* dx, int n_in, int d1, int d2, int dw, int dout,
                      int n_t, void* stream) {
  if (n_in == 0) return 0;
  const size_t smem = fused_uvu_conv_dx_smem(d1, d2, dw, dout, n_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_uvu_conv_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_uvu_conv_dx_kernel<<<n_in, THREADS, smem, (cudaStream_t)stream>>>(
      g, sh, w, dst, perm, row_ptr, (const int4*)t_meta, cg,
      (const int4*)out_meta, out_pw, dx_ptr, (const int4*)dx_meta, dx, d1, d2,
      dw, dout, n_t);
  return (int)cudaGetLastError();
}

int fused_uvu_conv_dw(const float* x, const float* g, const float* sh,
                      const int* src, const int* row_ptr, const void* t_meta,
                      const float* cg, const float* out_pw, const void* dw_meta,
                      float* dw_out, int n_out, int d1, int d2, int dw, int dout,
                      int n_t, void* stream) {
  if (n_out == 0) return 0;
  const size_t smem = fused_uvu_conv_dw_smem(d1, d2, dw, dout, n_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_uvu_conv_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_uvu_conv_dw_kernel<<<n_out, THREADS, smem, (cudaStream_t)stream>>>(
      x, g, sh, src, row_ptr, (const int4*)t_meta, cg, out_pw,
      (const int4*)dw_meta, dw_out, d1, d2, dw, dout, n_t);
  return (int)cudaGetLastError();
}

}  // extern "C"
