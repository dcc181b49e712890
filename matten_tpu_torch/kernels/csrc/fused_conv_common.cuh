// Shared by the fused uvu conv kernels (fused_conv.cu, fused_conv_bwd.cu):
// launch shape and the per-edge contraction of the CG blocks with sh.
#pragma once

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
