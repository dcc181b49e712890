// The species FCTPs of a conv layer (sc, lin1, lin2) as a per-species weight
// gather, for Hopper (sm_90a):
//
//   out[n, o_k + w d + i] = sum_{paths p into k} c_p sum_u x[n, x_p + u d + i] W_p[u, s_n, w]
//
// with W_p the path's [mul_in, S, mul_out] block of the flat weights, s_n the
// node's species and c_p = path weight / sqrt(2l + 1), and its gradients
//
//   dx[n, x_i + u d + i] = sum_{paths p from i} c_p sum_w g[n, o_p + w d + i] W_p[u, s_n, w]
//   dW_p[u, s, w]       = c_p sum_{n of species s} sum_i x[n, x_p + u d + i] g[n, o_p + w d + i]
//
// It replaces no TPU kernel: the JAX package computes these products in plain
// jnp (`ops/tensor_product.py`: the masked contraction against the one-hot,
// or `apply_onehot2`'s gather), and the port's plain versions of them built an
// [N, u, S, k] intermediate per path, all but 1/S of it products with zero.
//
// What bounds it on an H100: bytes. A forward reads the weight tables once
// (11.7 MiB for the 12 FCTPs of the 73-species production model), x and
// writes the outputs; the backward reads them again and writes dW. The
// operations, a linear map per node and path, are a few microseconds' worth.
//
// Design. Nodes are grouped by species (the species plan, built on the
// device: a stable sort of the species index with padded nodes keyed past
// the last species, its CSR offsets `seg_ptr` [S + 2] and the offsets
// `tile_ptr` [S + 2] of each segment's tiles of at most SF_TILE nodes). So a
// block reads one species' weights for all its nodes.
// * `species_linear_kernel` (the forward, and dx): block (tile, task). A task
//   is SF_CH channels a of one output irrep and its terms, the paths into it;
//   each term stages its input rows [nodes, b, i] and its weights [a, b]
//   (times c_p) in shared memory, SF_CH of the contracted channels b at a
//   time, and every thread adds the contraction of its output entries into
//   their sums in shared memory. The forward's a is w and b is u; dx's a is u
//   and b is w (W's strides say which). sc and lin1 share x, so one launch
//   computes both (two outputs; in dx, both products' cotangents are terms of
//   the same sums). A tile of the padded rows' segment writes zeros.
// * `species_dw_kernel`: block (species s, task); a task is SF_CH x SF_CH
//   weights of one path, summed over the species' nodes, SF_TILE nodes staged
//   at a time. A species without nodes writes zeros; padded rows are in no
//   species.
// Every sum has one fixed order and nothing is atomic: two runs are bitwise
// equal. Float32 storage, FMAs and sums throughout (no TF32).

#include <stdint.h>

#include <cuda_runtime.h>

#define SF_THREADS 128  // threads per block of both kernels
#define SF_TILE 16      // nodes per tile (the forward and dx) and per staged chunk (dW)
#define SF_CH 32        // output channels per task, contracted channels per staged chunk
#define SF_SLOTS (SF_CH * SF_CH / SF_THREADS)  // dW entries per thread

// the forward / dx: tasks [n_tasks, 8] int32 (out id, out offset, d, channels
// a, term begin, term end, 0, 0); terms [n_terms, 8] int32 (in id, in offset,
// contracted channels k, weight id, weight offset, stride of s, stride of a,
// stride of b) and their coefficients c_p
struct LinArgs {
  const float* in[2];
  int in_w[2];
  const float* w[2];
  float* out[2];
  int out_w[2];
  const int* perm;
  const int* seg_ptr;
  const int* tile_ptr;
  const int* tasks;
  const int* terms;
  const float* coefs;
  int n_species;
  int d_max;
};

__global__ void __launch_bounds__(SF_THREADS) species_linear_kernel(const LinArgs a) {
  extern __shared__ float smem[];
  __shared__ int rows[SF_TILE];
  const int tile = blockIdx.x;
  const int S = a.n_species;
  if (tile >= __ldg(a.tile_ptr + S + 1)) return;
  // the segment holding the tile: the last s in [0, S] with tile_ptr[s] <= tile
  int lo = 0, hi = S + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.tile_ptr + mid) <= tile) lo = mid; else hi = mid;
  }
  const int s = lo;
  const int first = __ldg(a.seg_ptr + s) + (tile - __ldg(a.tile_ptr + s)) * SF_TILE;
  const int nn = min(SF_TILE, __ldg(a.seg_ptr + s + 1) - first);
  const int* task = a.tasks + 8 * blockIdx.y;
  const int out_id = task[0], out_off = task[1], d = task[2], n_a = task[3];
  const int per_node = n_a * d;
  const int n_ent = nn * per_node;
  float* acc = smem;                                 // [nn, a, i]
  float* in_s = acc + SF_TILE * SF_CH * a.d_max;     // [nn, b, i]
  float* w_s = in_s + SF_TILE * SF_CH * a.d_max;     // [a, b], rows of SF_CH + 1
  if (threadIdx.x < nn) rows[threadIdx.x] = __ldg(a.perm + first + threadIdx.x);
  for (int e = threadIdx.x; e < n_ent; e += SF_THREADS) acc[e] = 0.f;
  __syncthreads();
  if (s < S) {
    for (int t = task[4]; t < task[5]; ++t) {
      const int* tm = a.terms + 8 * t;
      const int in_id = tm[0], in_off = tm[1], k = tm[2];
      const int st_a = tm[6], st_b = tm[7];
      const float* in = a.in[in_id];
      const int in_w = a.in_w[in_id];
      const float* W = a.w[tm[3]] + tm[4] + (size_t)s * tm[5];
      const float c = __ldg(a.coefs + t);
      for (int b0 = 0; b0 < k; b0 += SF_CH) {
        const int nb = min(SF_CH, k - b0);
        const int run = nb * d;
        for (int q = threadIdx.x; q < nn * run; q += SF_THREADS) {
          const int j = q / run, r = q - j * run;
          in_s[q] = __ldg(in + (size_t)rows[j] * in_w + in_off + b0 * d + r);
        }
        // the weights' unit stride fastest: dx reads rows of w, the forward columns of u
        for (int q = threadIdx.x; q < n_a * nb; q += SF_THREADS) {
          int ai, bi;
          if (st_b == 1) { ai = q / nb; bi = q - ai * nb; } else { bi = q / n_a; ai = q - bi * n_a; }
          w_s[ai * (SF_CH + 1) + bi] = c * __ldg(W + (size_t)ai * st_a + (size_t)(b0 + bi) * st_b);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < n_ent; e += SF_THREADS) {
          const int j = e / per_node, r = e - j * per_node;
          const int ai = r / d, i = r - ai * d;
          const float* xr = in_s + j * run + i;
          const float* wr = w_s + ai * (SF_CH + 1);
          float sum = 0.f;
          for (int bi = 0; bi < nb; ++bi) sum = fmaf(xr[bi * d], wr[bi], sum);
          acc[e] += sum;
        }
        __syncthreads();
      }
    }
  }
  float* out = a.out[out_id];
  const int out_w = a.out_w[out_id];
  for (int e = threadIdx.x; e < n_ent; e += SF_THREADS) {
    const int j = e / per_node, r = e - j * per_node;
    out[(size_t)rows[j] * out_w + out_off + r] = acc[e];
  }
}

// dW: tasks [n_tasks, 12] int32 (g id, x offset, g offset, d, channels u,
// channels w, weight id, weight offset, stride of s, stride of u, 0, 0) and
// their coefficients c_p
struct DwArgs {
  const float* x;
  int x_w;
  const float* g[2];
  int g_w[2];
  float* dw[2];
  const int* perm;
  const int* seg_ptr;
  const int* tasks;
  const float* coefs;
  int d_max;
};

__global__ void __launch_bounds__(SF_THREADS) species_dw_kernel(const DwArgs a) {
  extern __shared__ float smem[];
  __shared__ int rows[SF_TILE];
  const int s = blockIdx.x;
  const int* task = a.tasks + 12 * blockIdx.y;
  const int g_id = task[0], x_off = task[1], g_off = task[2], d = task[3];
  const int n_u = task[4], n_w = task[5];
  const float* g = a.g[g_id];
  const int g_w = a.g_w[g_id];
  const int ru = n_u * d, rw = n_w * d;
  float* xs = smem;                             // [SF_TILE, u, i]
  float* gs = xs + SF_TILE * SF_CH * a.d_max;   // [SF_TILE, w, i]
  const int n_ent = n_u * n_w;
  int uo[SF_SLOTS], wo[SF_SLOTS];
  float acc[SF_SLOTS];
#pragma unroll
  for (int q = 0; q < SF_SLOTS; ++q) {
    const int e = threadIdx.x + q * SF_THREADS;
    uo[q] = (e / max(n_w, 1)) * d;
    wo[q] = (e - (e / max(n_w, 1)) * n_w) * d;
    acc[q] = 0.f;
  }
  const int begin = __ldg(a.seg_ptr + s), end = __ldg(a.seg_ptr + s + 1);
  for (int j0 = begin; j0 < end; j0 += SF_TILE) {
    const int nn = min(SF_TILE, end - j0);
    __syncthreads();
    if (threadIdx.x < nn) rows[threadIdx.x] = __ldg(a.perm + j0 + threadIdx.x);
    __syncthreads();
    for (int q = threadIdx.x; q < nn * ru; q += SF_THREADS) {
      const int j = q / ru, r = q - j * ru;
      xs[q] = __ldg(a.x + (size_t)rows[j] * a.x_w + x_off + r);
    }
    for (int q = threadIdx.x; q < nn * rw; q += SF_THREADS) {
      const int j = q / rw, r = q - j * rw;
      gs[q] = __ldg(g + (size_t)rows[j] * g_w + g_off + r);
    }
    __syncthreads();
    for (int j = 0; j < nn; ++j) {
      const float* xr = xs + j * ru;
      const float* gr = gs + j * rw;
      for (int i = 0; i < d; ++i) {
#pragma unroll
        for (int q = 0; q < SF_SLOTS; ++q) {
          if (threadIdx.x + q * SF_THREADS < n_ent) acc[q] = fmaf(xr[uo[q] + i], gr[wo[q] + i], acc[q]);
        }
      }
    }
  }
  const float c = __ldg(a.coefs + blockIdx.y);
  float* dw = a.dw[task[6]] + task[7] + (size_t)s * task[8];
  const int st_u = task[9];
#pragma unroll
  for (int q = 0; q < SF_SLOTS; ++q) {
    const int e = threadIdx.x + q * SF_THREADS;
    if (e < n_ent) {
      const int u = e / n_w, w = e - u * n_w;
      dw[(size_t)u * st_u + w] = c * acc[q];
    }
  }
}

// Shared memory per block of each kernel at the tables' largest irrep dim
// (above 48 KB only once the kernel's opt-in is raised).
static size_t species_linear_smem(int d_max) {
  return sizeof(float) * (2 * (size_t)SF_TILE * SF_CH * d_max + SF_CH * (SF_CH + 1));
}

static size_t species_dw_smem(int d_max) { return sizeof(float) * 2 * (size_t)SF_TILE * SF_CH * d_max; }

static int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" {

// The forward or dx of a species FCTP group: in1 / w1 / out1 may be null
// (one input, weight table or output); tile_bound blocks over the tiles
// (those past tile_ptr[S + 1] exit). `tile` and `ch` are the wrapper's tile
// and channel chunk, which must be this file's. Launches on `stream`,
// allocates nothing, returns the cudaError_t of the launch (0 on success).
int species_linear(const float* in0, const float* in1, int in_w0, int in_w1, const float* w0,
                   const float* w1, float* out0, float* out1, int out_w0, int out_w1, const int* perm,
                   const int* seg_ptr, const int* tile_ptr, const int* tasks, const int* terms,
                   const float* coefs, int n_tasks, int tile_bound, int n_species, int d_max, int tile,
                   int ch, void* stream) {
  if (tile != SF_TILE || ch != SF_CH || n_tasks > 65535) return (int)cudaErrorInvalidValue;
  if (tile_bound == 0 || n_tasks == 0) return 0;
  LinArgs a{{in0, in1}, {in_w0, in_w1}, {w0, w1}, {out0, out1}, {out_w0, out_w1}, perm, seg_ptr,
            tile_ptr, tasks, terms, coefs, n_species, d_max};
  const size_t smem = species_linear_smem(d_max);
  const int err = set_smem((const void*)species_linear_kernel, smem);
  if (err) return err;
  species_linear_kernel<<<dim3(tile_bound, n_tasks), SF_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// dW of a species FCTP group: one block per (species, task); g1 / dw1 may be
// null. Launches on `stream`, allocates nothing, returns the cudaError_t of
// the launch (0 on success).
int species_dw(const float* x, int x_w, const float* g0, const float* g1, int g_w0, int g_w1, float* dw0,
               float* dw1, const int* perm, const int* seg_ptr, const int* tasks, const float* coefs,
               int n_tasks, int n_species, int d_max, int tile, int ch, void* stream) {
  if (tile != SF_TILE || ch != SF_CH || n_tasks > 65535) return (int)cudaErrorInvalidValue;
  if (n_species == 0 || n_tasks == 0) return 0;
  DwArgs a{x, x_w, {g0, g1}, {g_w0, g_w1}, {dw0, dw1}, perm, seg_ptr, tasks, coefs, d_max};
  const size_t smem = species_dw_smem(d_max);
  const int err = set_smem((const void*)species_dw_kernel, smem);
  if (err) return err;
  species_dw_kernel<<<dim3(n_species, n_tasks), SF_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
