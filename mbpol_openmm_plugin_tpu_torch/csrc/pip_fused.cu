// Fused evaluation of the MB-pol 2B/3B polynomials (energy and dE/dx per
// row) for Hopper (sm_90a): the four kernels that replace the Pallas bodies
// of mbpol_openmm_plugin_tpu/ops/pip_pallas.py.
//
//   pip_monomial_kernel      _kernel            monomial expansion through
//                                               exp(sum of log x); the
//                                               monomial matrix never
//                                               reaches memory
//   pip_quad_explog_kernel   _quad_kernel       quadratic form, basis
//                                               m2 = exp(log xa_i + log xa_j)
//   pip_quad_product_kernel  _quad_bf16_kernel  quadratic form, basis
//                                               m2 = xa_i * xa_j (exact
//                                               products, index tables)
//   pip_quad_vech_kernel     _vech_kernel       quadratic form over the
//                                               natural vech basis (no index
//                                               table), input transposed
//
// All take x [P, V] float32 (vech: xat = [x, 1]^T [V+1, P]) and write
// e [P] and g = dE/dx [P, V]. Plain fp32 FMA on the CUDA cores; the TPU
// kernels' bf16 multi-pass products are that chip's way to f32 accuracy and
// are not part of the function. No atomics: every sum runs in a fixed
// order, so results are bit-identical run to run. Tail rows are guarded in
// the kernels (no padded copy of x).
//
// What bounds them on the H100, at the water256 triplet batch (P ~ 24k-36k
// rows, V = 36):
//  - monomial: P x 33,525 expf and ~10 flops each; operations. One warp
//    holds 32 rows (lane = row) and one of 8 slices of the monomial list, so
//    the factor indices and the coefficient are warp-uniform loads and the
//    per-row log x and the (double) gradient accumulators live in shared
//    memory as [variable][lane] (conflict-free under a uniform index). The 8
//    slices are summed at the end in slice order.
//  - quadratic forms: 2 P B^2 flops of the W product (B = 703); operations.
//    A block owns 32 rows: the basis tile m2 [B][32] stays in shared memory,
//    W (1.98 MB, resident in L2 after the first blocks) streams through
//    shared memory in 16 x 128 tiles with a register prefetch, each thread
//    accumulates a 4 x 4 register tile, and z = 2 m2 (m2 W) goes to a second
//    [B][32] buffer. The gradient contraction z @ F has <= 2 nonzeros per
//    basis row: thread (row, variable) sums its variable's z entries through
//    a per-variable list (vech: closed-form indices) in list order.
//
// The C entry points take device pointers, sizes and the stream, allocate
// nothing and return the first CUDA error (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                   // rows per block (all kernels)
constexpr int kSlices = kThreads / kRows;   // monomial slices per block
constexpr int kTK = 16;                     // W tile: k extent
constexpr int kTC = 128;                    // W tile: output columns
constexpr int kPre = kTK * kTC / kThreads;  // W tile floats per thread

// ---------------------------------------------------------------------
// Monomial expansion
// ---------------------------------------------------------------------

// Sums over monomials run in double: a slice adds ~4,200 terms that cancel
// over three orders of magnitude, and in float32 that chain alone left the
// kernel 1.3x (e) and 1.7x (g) further from float64 than the plain float32
// evaluation; with double sums the float32 rounding of log, exp and c * mono
// is all that is left.
using Acc = double;

size_t monomial_smem_bytes(int v) {
  return sizeof(Acc) * (size_t)(kSlices * (v + 1) * kRows + kSlices * kRows)
         + sizeof(float) * (size_t)((v + 1) * kRows);
}

__global__ void __launch_bounds__(kThreads)
pip_monomial_kernel(const float* __restrict__ x, int p, int v,
                    const uchar4* __restrict__ factors, const float* __restrict__ coeffs,
                    int nmono, float* __restrict__ e_out, float* __restrict__ g_out) {
  extern __shared__ __align__(16) float smem[];
  const int va = v + 1;                      // slot v: log 1 = 0, gradient dump
  Acc* gs = reinterpret_cast<Acc*>(smem);    // [kSlices][va][kRows]
  Acc* es = gs + kSlices * va * kRows;       // [kSlices][kRows]
  float* la = reinterpret_cast<float*>(es + kSlices * kRows);   // [va][kRows] log x
  const int t = threadIdx.x, r = t % kRows, s = t / kRows;
  const size_t base = (size_t)blockIdx.x * kRows * v;
  const int nrows = min(kRows, p - blockIdx.x * kRows);

  for (int i = t; i < kRows * v; i += kThreads) {
    const int rr = i / v, a = i % v;
    la[a * kRows + rr] = rr < nrows ? logf(x[base + i]) : 0.0f;
  }
  if (t < kRows) la[v * kRows + t] = 0.0f;
  Acc* g = gs + s * va * kRows + r;
  for (int a = 0; a < va; ++a) g[a * kRows] = 0;
  __syncthreads();

  const int chunk = (nmono + kSlices - 1) / kSlices;
  const int m1 = min(nmono, (s + 1) * chunk);
  const float* l = la + r;
  Acc e = 0;
  for (int m = s * chunk; m < m1; ++m) {
    const uchar4 k = factors[m];
    const float sum = ((l[k.x * kRows] + l[k.y * kRows]) + l[k.z * kRows]) + l[k.w * kRows];
    const float mc = coeffs[m] * expf(sum);
    e += mc;
    g[k.x * kRows] += mc;
    g[k.y * kRows] += mc;
    g[k.z * kRows] += mc;
    g[k.w * kRows] += mc;
  }
  es[s * kRows + r] = e;
  __syncthreads();

  for (int i = t; i < nrows * v; i += kThreads) {
    const int rr = i / v, a = i % v;
    Acc sum = 0;
    for (int q = 0; q < kSlices; ++q) sum += gs[(q * va + a) * kRows + rr];
    g_out[base + i] = static_cast<float>(sum) / x[base + i];
  }
  if (t < nrows) {
    Acc sum = 0;
    for (int q = 0; q < kSlices; ++q) sum += es[q * kRows + t];
    e_out[(size_t)blockIdx.x * kRows + t] = static_cast<float>(sum);
  }
}

// ---------------------------------------------------------------------
// Quadratic forms
// ---------------------------------------------------------------------

enum Basis { kExpLog = 0, kProduct = 1, kVech = 2 };

__device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Offset of block i of the vech order over va augmented variables.
__device__ __forceinline__ int vech_offset(int i, int va) { return i * va - i * (i - 1) / 2; }

// One 16 x 128 tile of W (rows k0.., columns n0..) into registers; zero
// outside [b, b].
__device__ __forceinline__ void load_w_tile(const float* __restrict__ w, int b, int k0, int n0,
                                            float (&pre)[kPre]) {
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int i = threadIdx.x + kThreads * q;
    const int k = k0 + i / kTC, n = n0 + i % kTC;
    pre[q] = (k < b && n < b) ? w[(size_t)k * b + n] : 0.0f;
  }
}

// xin: x [p, v] (kExpLog, kProduct) or xat [v + 1, p] (kVech).
// ia, ib [b]: factor indices of the basis (unused for kVech).
// gptr [v + 1], gk: per-variable lists of basis rows, a row listed twice
// where the variable enters squared (unused for kVech).
template <Basis kBasis>
__device__ __forceinline__ void quad_body(const float* __restrict__ xin, int p, int v, int b,
                                          const int* __restrict__ ia,
                                          const int* __restrict__ ib,
                                          const float* __restrict__ w,
                                          const int* __restrict__ gptr,
                                          const int* __restrict__ gk,
                                          float* __restrict__ e_out,
                                          float* __restrict__ g_out) {
  extern __shared__ __align__(16) float smem[];
  const int va = v + 1;
  const int bp = round_up(b, kTK);
  float* m2s = smem;                    // [bp][kRows] basis values
  float* zs = m2s + bp * kRows;         // [bp][kRows] z = 2 m2 (m2 W)
  float* ws = zs + bp * kRows;          // [kTK][kTC] W tile
  float* xs = ws + kTK * kTC;           // [va][kRows] xa (kExpLog: log xa)
  float* es = xs + va * kRows;          // [4][kRows] energy partials
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, p - row0);
  const size_t base = (size_t)row0 * v;

  // 1. the tile's variables; tail rows get xa = 1
  if constexpr (kBasis == kVech) {
    for (int i = t; i < va * kRows; i += kThreads) {
      const int a = i / kRows, rr = i % kRows;
      xs[i] = rr < nrows ? xin[(size_t)a * p + row0 + rr] : 1.0f;
    }
  } else {
    for (int i = t; i < kRows * v; i += kThreads) {
      const int rr = i / v, a = i % v;
      const float val = rr < nrows ? xin[base + i] : 1.0f;
      xs[a * kRows + rr] = kBasis == kExpLog ? logf(val) : val;
    }
    if (t < kRows) xs[v * kRows + t] = kBasis == kExpLog ? 0.0f : 1.0f;
  }
  __syncthreads();

  // 2. the basis tile m2 [bp][kRows] (rows b..bp zero)
  if constexpr (kBasis == kVech) {
    for (int i = t; i < va * kRows; i += kThreads) {
      const int a = i / kRows, rr = i % kRows;
      const float xa = xs[i];
      float* dst = m2s + (vech_offset(a, va) - a) * kRows + rr;
      for (int j = a; j < va; ++j) dst[j * kRows] = xa * xs[j * kRows + rr];
    }
  } else {
    for (int i = t; i < b * kRows; i += kThreads) {
      const int k = i / kRows, rr = i % kRows;
      const float fa = xs[ia[k] * kRows + rr], fb = xs[ib[k] * kRows + rr];
      m2s[i] = kBasis == kExpLog ? expf(fa + fb) : fa * fb;
    }
  }
  for (int i = b * kRows + t; i < bp * kRows; i += kThreads) m2s[i] = 0.0f;
  __syncthreads();

  // 3. wm = m2 W in 32 x 128 output chunks; a warp covers 16 rows x 32
  // columns (lane = column group + 8 * row group), a thread 4 x 4
  const int lane = t % 32, warp = t / 32;
  const int rbase = (warp / 4) * 16 + (lane / 8) * 4;       // first of 4 rows
  const int cbase = (warp % 4) * 32 + (lane % 8) * 4;       // first of 4 columns in the chunk
  float erow[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float pre[kPre];
  for (int n0 = 0; n0 < b; n0 += kTC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    load_w_tile(w, b, 0, n0, pre);
    for (int k0 = 0; k0 < bp; k0 += kTK) {
      __syncthreads();                  // the previous tile is consumed
#pragma unroll
      for (int q = 0; q < kPre; ++q) ws[t + kThreads * q] = pre[q];
      __syncthreads();
      if (k0 + kTK < bp) load_w_tile(w, b, k0 + kTK, n0, pre);
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(m2s + (k0 + kk) * kRows + rbase);
        const float4 b4 = *reinterpret_cast<const float4*>(ws + kk * kTC + cbase);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cbase + j;
      if (n < b) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mw = m2s[n * kRows + rbase + i] * acc[i][j];
          erow[i] += mw;
          zs[n * kRows + rbase + i] = 2.0f * mw;
        }
      }
    }
  }
  // energy: over the 8 column groups of the warp, then the 4 column warps
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float e = erow[i];
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    e += __shfl_xor_sync(0xffffffffu, e, 2);
    e += __shfl_xor_sync(0xffffffffu, e, 4);
    if (lane % 8 == 0) es[(warp % 4) * kRows + rbase + i] = e;
  }
  __syncthreads();                      // zs and es complete
  if (t < nrows)
    e_out[row0 + t] = ((es[t] + es[kRows + t]) + es[2 * kRows + t]) + es[3 * kRows + t];

  // 4. gradient: sum_k F[k, a] z_k per (variable, row), staged in xs (its
  // last readers finished in step 2)
  for (int i = t; i < v * kRows; i += kThreads) {
    const int a = i / kRows, rr = i % kRows;
    float sum = 0.0f;
    if constexpr (kBasis == kVech) {
      for (int j = 0; j < va; ++j) {
        const int lo = min(a, j), hi = max(a, j);
        const float z = zs[(vech_offset(lo, va) + hi - lo) * kRows + rr];
        sum += (j == a) ? z + z : z;
      }
    } else {
      for (int q = gptr[a]; q < gptr[a + 1]; ++q) sum += zs[gk[q] * kRows + rr];
    }
    xs[i] = sum;
  }
  __syncthreads();
  for (int i = t; i < nrows * v; i += kThreads) {
    const int rr = i / v, a = i % v;
    const float xv = kBasis == kVech ? xin[(size_t)a * p + row0 + rr] : xin[base + i];
    g_out[base + i] = xs[a * kRows + rr] / xv;
  }
}

__global__ void __launch_bounds__(kThreads)
pip_quad_explog_kernel(const float* __restrict__ x, int p, int v, int b,
                       const int* __restrict__ ia, const int* __restrict__ ib,
                       const float* __restrict__ w, const int* __restrict__ gptr,
                       const int* __restrict__ gk, float* __restrict__ e_out,
                       float* __restrict__ g_out) {
  quad_body<kExpLog>(x, p, v, b, ia, ib, w, gptr, gk, e_out, g_out);
}

__global__ void __launch_bounds__(kThreads)
pip_quad_product_kernel(const float* __restrict__ x, int p, int v, int b,
                        const int* __restrict__ ia, const int* __restrict__ ib,
                        const float* __restrict__ w, const int* __restrict__ gptr,
                        const int* __restrict__ gk, float* __restrict__ e_out,
                        float* __restrict__ g_out) {
  quad_body<kProduct>(x, p, v, b, ia, ib, w, gptr, gk, e_out, g_out);
}

__global__ void __launch_bounds__(kThreads)
pip_quad_vech_kernel(const float* __restrict__ xat, int p, int v, int b,
                     const float* __restrict__ w, float* __restrict__ e_out,
                     float* __restrict__ g_out) {
  quad_body<kVech>(xat, p, v, b, nullptr, nullptr, w, nullptr, nullptr, e_out, g_out);
}

size_t quad_smem_bytes(int v, int b) {
  const int bp = (b + kTK - 1) / kTK * kTK;
  return sizeof(float) * (size_t)(2 * bp * kRows + kTK * kTC + (v + 1) * kRows + 4 * kRows);
}

// Dynamic shared memory above 48 KB must be asked for; the answer is checked.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int mbpol_pip_monomial(const float* x, int p, int v, const void* factors,
                                  const float* coeffs, int nmono, float* e, float* g,
                                  void* stream) {
  if (p <= 0) return 0;
  const size_t bytes = monomial_smem_bytes(v);
  const cudaError_t rc = allow_smem(pip_monomial_kernel, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  pip_monomial_kernel<<<(p + kRows - 1) / kRows, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, p, v, static_cast<const uchar4*>(factors), coeffs, nmono, e, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_pip_quad_explog(const float* x, int p, int v, int b, const int* ia,
                                     const int* ib, const float* w, const int* gptr,
                                     const int* gk, float* e, float* g, void* stream) {
  if (p <= 0) return 0;
  const size_t bytes = quad_smem_bytes(v, b);
  const cudaError_t rc = allow_smem(pip_quad_explog_kernel, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  pip_quad_explog_kernel<<<(p + kRows - 1) / kRows, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(x, p, v, b, ia, ib, w, gptr, gk,
                                                                e, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_pip_quad_product(const float* x, int p, int v, int b, const int* ia,
                                      const int* ib, const float* w, const int* gptr,
                                      const int* gk, float* e, float* g, void* stream) {
  if (p <= 0) return 0;
  const size_t bytes = quad_smem_bytes(v, b);
  const cudaError_t rc = allow_smem(pip_quad_product_kernel, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  pip_quad_product_kernel<<<(p + kRows - 1) / kRows, kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(x, p, v, b, ia, ib, w, gptr,
                                                                 gk, e, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_pip_quad_vech(const float* xat, int p, int v, int b, const float* w,
                                   float* e, float* g, void* stream) {
  if (p <= 0) return 0;
  if (b != (v + 1) * (v + 2) / 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = quad_smem_bytes(v, b);
  const cudaError_t rc = allow_smem(pip_quad_vech_kernel, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  pip_quad_vech_kernel<<<(p + kRows - 1) / kRows, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(xat, p, v, b, w, e, g);
  return static_cast<int>(cudaGetLastError());
}
