// Device code that the fused uvu conv's forward (fused_conv.cu) and its
// merged backward (fused_conv_bwd.cu) share: both walk runs of at most 16,
// 8 or 4 consecutive dst-sorted edges per block (the launch's tier), stage
// the run's sh rows, w rows (where they fit) and the CG blocks contracted
// with sh (t_e) in shared memory, and read the same per-plan tables
// (kernels/fused_conv.py::tile_tables).
//
//   t_e[i] = sum_{m2} C_i[m2] * sh[e, sh_off(i) + m2]
//
// over the (m1, m3) entries i of the CG blocks C = wigner_3j(l1, l2, l3)
// that the plan's paths share.
//
// sh and w are stored as float or as __nv_bfloat16 (the storage dtype the
// wrapper's `set_kernel_in_dtype` selects, the JAX kernels' kernel-input
// dtype): both kernels are templates over that type, the w rows are staged
// at their storage width and every value is widened to float where it is
// read, so all arithmetic and every output stay float32.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The largest d1, d2_i and d3 (l <= 4, the production range) of the
// unrolled fast paths; irreps above l = 4 take the generic paths, which
// keep at most CONV_MAX_D accumulators in registers for any l.
#define CONV_MAX_D 9

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A read-only global load widened to float (a bf16 is the upper half of
// the float it rounds).
static __device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
static __device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One element outside the 16-byte copies: a float by a 4-byte cp.async; a
// bf16 by a plain load and store, since cp.async has no 2-byte size and a
// bf16 row at e0 * dw * 2 bytes is often not 4-byte aligned (the
// __syncthreads after cp_async_wait_all publishes both kinds alike).
static __device__ __forceinline__ void copy_one(float* dst, const float* src) { cp_async4(dst, src); }
static __device__ __forceinline__ void copy_one(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = *src;
}

// Elements of T a block needs for a run of n staged by cp_async_rows: the
// run, its pad of up to V - 1 and a round-up to a 16-byte multiple.
template <typename T>
static __host__ __device__ __forceinline__ size_t staged_len(size_t n) {
  constexpr size_t V = 16 / sizeof(T);
  return (n + 2 * (V - 1)) / V * V;
}

// Start copying n contiguous elements of T (float or bf16) from global
// `src` to shared memory at dst + pad, pad = the element offset of src
// within its 16-byte line, so that both sides share their 16-byte
// alignment and the bulk moves 16 bytes (V = 16 / sizeof(T) elements) per
// cp.async; dst is 16-byte aligned and has room for staged_len<T>(n)
// elements. Returns pad. Every thread of the block calls it;
// cp_async_wait_all then __syncthreads before the copy is read.
template <int THREADS, typename T>
static __device__ __forceinline__ int cp_async_rows(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int pad = static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) & (V - 1));
  const int head = min((V - pad) & (V - 1), n);
  T* d = dst + pad;
  const int nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += THREADS) copy_one(d + i, src + i);
  for (int v = threadIdx.x; v < nv; v += THREADS) cp_async16(d + head + V * v, src + head + V * v);
  for (int i = head + V * nv + threadIdx.x; i < n; i += THREADS) copy_one(d + i, src + i);
  return pad;
}

// The sh rows of edges e0 .. e0 + nj - 1 into shs [nj][shp] as floats (sh
// stored as float or bf16), each sh irrep padded to a multiple of 4 floats
// with zeros (sh_src: the sh component of each padded slot, or -1), so that
// contract_te reads them 16 bytes at a time.
template <int THREADS, typename T>
static __device__ __forceinline__ void stage_sh_rows(
    float* shs, const T* __restrict__ sh, const int* __restrict__ sh_src,
    int e0, int nj, int d2, int shp) {
  for (int idx = threadIdx.x; idx < nj * shp; idx += THREADS) {
    const int j = idx / shp;
    const int c = __ldg(sh_src + idx - j * shp);
    shs[idx] = c >= 0 ? ldg_f32(sh + (size_t)(e0 + j) * d2 + c) : 0.f;
  }
}

// ts[j][i] = t_e[i] of the nj staged edges (row stride ts_stride). One CG
// entry per thread for all nj edges. cg_t is [rows][n_t] (zero past d2_i),
// rows >= CONV_MAX_D and >= every d2_i rounded up to 4. An entry of
// d2_i <= CONV_MAX_D loads its CONV_MAX_D coefficients once, together, into
// registers; with ANY_L (a plan with irreps above l = 4) a larger one loads
// them 4 at a time, each 4 a pass over the edges. The sh segment (t_sh[i]:
// where entry i's irrep starts in a padded row) is read 4 floats at a time,
// and its zero padding adds exact zeros.
template <int THREADS, bool ANY_L>
static __device__ __forceinline__ void contract_te(
    float* ts, int ts_stride, const float* shs, int shp, const int4* __restrict__ t_meta,
    const float* __restrict__ cg_t, const int* __restrict__ t_sh, int n_t, int nj) {
  for (int i = threadIdx.x; i < n_t; i += THREADS) {
    const int d2i = __ldg(t_meta + i).z;
    if (ANY_L && d2i > CONV_MAX_D) {
      const float4* y = reinterpret_cast<const float4*>(shs + __ldg(t_sh + i));
      // 4 coefficients at a time, each chunk a pass over the edges that
      // adds into their t_e entries
      for (int q = 0; 4 * q < d2i; ++q) {
        const float* cq = cg_t + (size_t)(4 * q) * n_t + i;
        const float c0 = __ldg(cq), c1 = __ldg(cq + n_t), c2 = __ldg(cq + 2 * n_t), c3 = __ldg(cq + 3 * n_t);
        for (int j = 0; j < nj; ++j) {
          const float4 v = y[j * (shp / 4) + q];
          float acc = q ? ts[j * ts_stride + i] : 0.f;
          acc = fmaf(c0, v.x, acc);
          acc = fmaf(c1, v.y, acc);
          acc = fmaf(c2, v.z, acc);
          acc = fmaf(c3, v.w, acc);
          ts[j * ts_stride + i] = acc;
        }
      }
      continue;
    }
    float c[CONV_MAX_D];
#pragma unroll
    for (int m2 = 0; m2 < CONV_MAX_D; ++m2) c[m2] = __ldg(cg_t + (size_t)m2 * n_t + i);
    const float4* y = reinterpret_cast<const float4*>(shs + __ldg(t_sh + i));
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const float4* r = y + j * (shp / 4);
      const float4 v0 = r[0];
      float acc = fmaf(c[0], v0.x, 0.f);
      acc = fmaf(c[1], v0.y, acc);
      acc = fmaf(c[2], v0.z, acc);
      acc = fmaf(c[3], v0.w, acc);
      if (d2i > 4) {
        const float4 v1 = r[1];
        acc = fmaf(c[4], v1.x, acc);
        acc = fmaf(c[5], v1.y, acc);
        acc = fmaf(c[6], v1.z, acc);
        acc = fmaf(c[7], v1.w, acc);
      }
      if (d2i > 8) acc = fmaf(c[8], r[2].x, acc);
      ts[j * ts_stride + i] = acc;
    }
  }
}
