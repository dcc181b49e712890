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
// of the CG blocks C = wigner_3j(l1, l2, l3) that the paths share. The
// per-plan tables (out_meta, out_pw, t_meta, cg) are built once per plan by
// the Python wrapper and read through the read-only cache.
//
// Design. Edges arrive sorted by destination; the wrapper passes CSR row
// offsets. One thread block owns one destination node: it walks the node's
// edges EDGES_PER_STAGE at a time, stages x[src], sh and w of those edges in
// shared memory, contracts the CG blocks with sh once per edge, and then
// every thread adds the messages of its own output components to a
// shared-memory accumulator that it alone touches. The node's [dout] row is
// written once at the end. Messages never reach device memory, there are no
// atomics, and the summation order is fixed, so the result is deterministic.
//
// What bounds it on an H100: device-memory traffic is the inputs read once
// (w [E, dw] dominates: at the production layer 3, 21504 x 842 x 4 B, about
// 72 MB per call) plus the [N, dout] output; the plain PyTorch version writes
// and reads [E, dout] messages instead (about 360 MB at that layer). The
// arithmetic, about 2 * sum_o d1(o) FMAs per edge, is done from shared memory
// in fp32 on the CUDA cores, so this first kernel is bound by shared-memory
// bandwidth and by one block per node; wgmma/TMA staging and splitting
// high-degree nodes are later work.

#include <stdint.h>

#include <cuda_runtime.h>

#define THREADS 256
#define EDGES_PER_STAGE 4

// t_e[i] = sum_{m2} C_i[m2] * sh[e, sh_off(i) + m2] for the nj edges staged
// in shared memory (shs [nj, d2] -> ts [nj, n_t]); t_meta[i] = (cg offset,
// sh offset, d2_i, 0). Every thread of the block takes part.
static __device__ __forceinline__ void contract_sh(
    const float* shs, float* ts, const int4* __restrict__ t_meta,
    const float* __restrict__ cg, int nj, int d2, int n_t) {
  for (int idx = threadIdx.x; idx < nj * n_t; idx += THREADS) {
    const int j = idx / n_t;
    const int i = idx - j * n_t;
    const int4 tm = __ldg(t_meta + i);
    const float* c = cg + tm.x;
    const float* y = shs + j * d2 + tm.y;
    float s = 0.f;
    for (int m2 = 0; m2 < tm.z; ++m2) s = fmaf(__ldg(c + m2), y[m2], s);
    ts[j * n_t + i] = s;
  }
}

__global__ void __launch_bounds__(THREADS) fused_uvu_conv_fwd_kernel(
    const float* __restrict__ x,         // [n_in, d1]
    const float* __restrict__ sh,        // [E, d2]
    const float* __restrict__ w,         // [E, dw]
    const int* __restrict__ src,         // [E]
    const int* __restrict__ row_ptr,     // [n_out + 1]
    const int4* __restrict__ t_meta,     // [n_t]: cg_off, sh_off, d2_i, 0
    const float* __restrict__ cg,        // CG entries, d2_i per t entry
    const int4* __restrict__ out_meta,   // [dout]: x_idx, t_idx, w_idx, d1 | d3 << 16
    const float* __restrict__ out_pw,    // [dout] path weight of each component
    float* __restrict__ out,             // [n_out, dout]
    int d1, int d2, int dw, int dout, int n_t) {
  extern __shared__ float smem[];
  float* acc = smem;                               // [dout]
  float* xs = acc + dout;                          // [EDGES_PER_STAGE, d1]
  float* ws = xs + EDGES_PER_STAGE * d1;           // [EDGES_PER_STAGE, dw]
  float* shs = ws + EDGES_PER_STAGE * dw;          // [EDGES_PER_STAGE, d2]
  float* ts = shs + EDGES_PER_STAGE * d2;          // [EDGES_PER_STAGE, n_t]

  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  const int e_begin = row_ptr[node];
  const int e_end = row_ptr[node + 1];

  for (int o = tid; o < dout; o += THREADS) acc[o] = 0.f;

  for (int e0 = e_begin; e0 < e_end; e0 += EDGES_PER_STAGE) {
    const int nj = min(EDGES_PER_STAGE, e_end - e0);

    // stage the gathered source features and the edge arrays
    for (int j = 0; j < nj; ++j) {
      const int e = e0 + j;
      const float* xrow = x + (size_t)src[e] * d1;
      const float* wrow = w + (size_t)e * dw;
      const float* shrow = sh + (size_t)e * d2;
      for (int c = tid; c < d1; c += THREADS) xs[j * d1 + c] = xrow[c];
      for (int c = tid; c < dw; c += THREADS) ws[j * dw + c] = wrow[c];
      for (int c = tid; c < d2; c += THREADS) shs[j * d2 + c] = shrow[c];
    }
    __syncthreads();

    // t_e = CG blocks contracted with sh, shared by every channel u
    contract_sh(shs, ts, t_meta, cg, nj, d2, n_t);
    __syncthreads();

    // each thread owns output components o = tid + k * THREADS
    for (int o = tid; o < dout; o += THREADS) {
      const int4 om = __ldg(out_meta + o);
      const int pd1 = om.w & 0xffff;
      const int pd3 = om.w >> 16;
      float a = acc[o];
      for (int j = 0; j < nj; ++j) {
        const float* t = ts + j * n_t + om.y;
        const float* xu = xs + j * d1 + om.x;
        float s = 0.f;
        for (int m1 = 0; m1 < pd1; ++m1) s = fmaf(t[m1 * pd3], xu[m1], s);
        a = fmaf(ws[j * dw + om.z], s, a);
      }
      acc[o] = a;
    }
    __syncthreads();
  }

  float* orow = out + (size_t)node * dout;
  for (int o = tid; o < dout; o += THREADS) orow[o] = acc[o] * __ldg(out_pw + o);
}

extern "C" {

// Shared memory (bytes) one block needs; the wrapper names it when a launch
// fails (the production plans need at most about 68 KB of the 227 KB).
size_t fused_uvu_conv_fwd_smem(int d1, int d2, int dw, int dout, int n_t) {
  return sizeof(float) *
         ((size_t)dout + (size_t)EDGES_PER_STAGE * ((size_t)d1 + dw + d2 + n_t));
}

// Launches on `stream`; allocates nothing. Returns the cudaError_t of the
// launch (0 on success).
int fused_uvu_conv_fwd(const float* x, const float* sh, const float* w,
                       const int* src, const int* row_ptr, const void* t_meta,
                       const float* cg, const void* out_meta, const float* out_pw,
                       float* out, int n_out, int d1, int d2, int dw, int dout,
                       int n_t, void* stream) {
  if (n_out == 0) return 0;
  const size_t smem = fused_uvu_conv_fwd_smem(d1, d2, dw, dout, n_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_uvu_conv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_uvu_conv_fwd_kernel<<<n_out, THREADS, smem, (cudaStream_t)stream>>>(
      x, sh, w, src, row_ptr, (const int4*)t_meta, cg, (const int4*)out_meta,
      out_pw, out, d1, d2, dw, dout, n_t);
  return (int)cudaGetLastError();
}

}  // extern "C"
