// Deterministic segment sum of rows, for Hopper (sm_90a):
//
//   out[s, :] = sum_{k = ptr[s]}^{ptr[s + 1] - 1} rows[perm ? perm[k] : k, :]
//
// in a fixed order, without atomics (an empty segment gives a zero row). The
// fused uvu conv uses it twice:
// * K1's partial rows (fused_conv.cu): rows [items, dout], no permutation,
//   ptr = the items of each destination node;
// * dx of the merged backward (fused_conv_bwd.cu): rows = the per-edge dx
//   rows [E, d1], perm = a stable argsort of src, ptr = each source node's
//   edges in it.
// Together they replace the TPU kernels' in-kernel scatters into the nodes
// (matten_tpu/kernels/fused_conv.py: `_build_fwd2`'s one-hot segment sum
// into dst, and `_build_bwd2`'s and the transposed `_build_call`'s dx
// scatter into src).
//
// Design. A block is (segment s, a chunk of columns): cb threads over the
// chunk's columns, V floats each (V = 4 or 2 where the row width and the
// pointers allow 16- or 8-byte loads: every production width is even), and
// rs = blockDim / cb threads over the segment's rows, thread r taking rows
// r, r + rs, ... with SUM_UNROLL loads in flight, each added in row order.
// The rs partial sums are then added in r order. rs grows with the mean
// segment length (rows / segments, known from the shapes) until a thread
// has about SUM_UNROLL rows, so a long segment (a source of degree 159 in
// dx) takes a few rounds of loads, not one per 8 of its rows; narrow rows
// (d1 = 16) spread over rows and wide rows (dout = 4170, 5 partial rows per
// node) over columns and blocks. Every sum has one fixed order: two runs
// are bitwise equal. A segment's perm entries are staged in shared memory
// once per block, not read by every thread.
//
// What bounds it on an H100: bytes. Every row is read once and every output
// row written once (dx at the production layer 3: 21504 x 246 x 4 B, 21 MB,
// 6.3 us at 3.35 TB/s; K1's partial rows there: 1488 x 4170 x 4 B, 25 MB);
// one add per element read.

#include <stdint.h>

#include <cuda_runtime.h>

#define SUM_THREADS 256  // most threads a block has
#define SUM_MAX_RS 16    // most threads over one segment's rows
#define SUM_UNROLL 8     // loads in flight per thread

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, const T& b) { a.x += b.x; a.y += b.y; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
};

// cols: row width in units of V floats; cb_log2: log2 of the column threads
// per block; n_chunks: column chunks per segment.
template <int V, bool PERM>
__global__ void __launch_bounds__(SUM_THREADS) segment_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ perm, const int* __restrict__ ptr,
    float* __restrict__ out, int cols, int cb_log2, int n_chunks) {
  using T = typename Vec<V>::T;
  __shared__ int idx_s[SUM_THREADS];
  __shared__ T part_s[SUM_THREADS];
  const int seg = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - seg * n_chunks;
  const int cb = 1 << cb_log2;
  const int rs = blockDim.x >> cb_log2;
  const int tc = threadIdx.x & (cb - 1);
  const int tr = threadIdx.x >> cb_log2;
  const int c = chunk * cb + tc;
  const bool on = c < cols;
  const T* R = reinterpret_cast<const T*>(rows) + c;
  const int k_begin = __ldg(ptr + seg);
  const int k_end = __ldg(ptr + seg + 1);
  T acc = Vec<V>::zero();
  for (int k0 = k_begin; k0 < k_end; k0 += SUM_THREADS) {
    const int cnt = min(SUM_THREADS, k_end - k0);
    if (PERM) {
      __syncthreads();
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) idx_s[i] = __ldg(perm + k0 + i);
      __syncthreads();
    }
    if (on) {
      int r = tr;
      for (; r + (SUM_UNROLL - 1) * rs < cnt; r += SUM_UNROLL * rs) {
        T v[SUM_UNROLL];
#pragma unroll
        for (int q = 0; q < SUM_UNROLL; ++q) {
          const int row = PERM ? idx_s[r + q * rs] : k0 + r + q * rs;
          v[q] = __ldg(R + (size_t)row * cols);
        }
#pragma unroll
        for (int q = 0; q < SUM_UNROLL; ++q) Vec<V>::add(acc, v[q]);
      }
      for (; r < cnt; r += rs) {
        const int row = PERM ? idx_s[r] : k0 + r;
        Vec<V>::add(acc, __ldg(R + (size_t)row * cols));
      }
    }
  }
  if (rs > 1) {
    part_s[threadIdx.x] = acc;
    __syncthreads();
    if (tr == 0) {
      for (int q = 1; q < rs; ++q) Vec<V>::add(acc, part_s[q * cb + tc]);
    }
  }
  if (tr == 0 && on) reinterpret_cast<T*>(out)[(size_t)seg * cols + c] = acc;
}

template <int V, bool PERM>
static int launch(const float* rows, const int* perm, const int* ptr, float* out, int n_seg,
                  int width, int n_rows, cudaStream_t stream) {
  const int cols = width / V;
  // row threads wanted: the mean segment over SUM_UNROLL rows, a power of two
  int rs_want = 1;
  while (rs_want < SUM_MAX_RS && (long long)rs_want * SUM_UNROLL * n_seg < n_rows) rs_want <<= 1;
  int cb_log2 = 0;
  while ((1 << cb_log2) < cols && (1 << cb_log2) < SUM_THREADS / rs_want) ++cb_log2;
  const int cb = 1 << cb_log2;
  const int rs = min(SUM_THREADS / cb, SUM_MAX_RS);
  const int n_chunks = (cols + cb - 1) / cb;
  const long long blocks = (long long)n_seg * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<V, PERM><<<(unsigned)blocks, cb * rs, 0, stream>>>(
      rows, perm, ptr, out, cols, cb_log2, n_chunks);
  return (int)cudaGetLastError();
}

template <bool PERM>
static int launch_v(const float* rows, const int* perm, const int* ptr, float* out, int n_seg,
                    int width, int n_rows, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out);
  if (width % 4 == 0 && a % 16 == 0)
    return launch<4, PERM>(rows, perm, ptr, out, n_seg, width, n_rows, stream);
  if (width % 2 == 0 && a % 8 == 0)
    return launch<2, PERM>(rows, perm, ptr, out, n_seg, width, n_rows, stream);
  return launch<1, PERM>(rows, perm, ptr, out, n_seg, width, n_rows, stream);
}

extern "C" {

// out [n_seg, width] from rows [*, width]; perm null: no permutation.
// n_rows: the rows of `rows` (at least ptr[n_seg], the rows summed in all;
// the wrapper passes it from the shapes), which sets the threads per
// segment. Launches on `stream`,
// allocates nothing, returns the cudaError_t of the launch (0 on success).
int segment_sum(const float* rows, const int* perm, const int* ptr, float* out, int n_seg,
                int width, int n_rows, void* stream) {
  if (n_seg == 0 || width == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return perm ? launch_v<true>(rows, perm, ptr, out, n_seg, width, n_rows, s)
              : launch_v<false>(rows, perm, ptr, out, n_seg, width, n_rows, s);
}

}  // extern "C"
