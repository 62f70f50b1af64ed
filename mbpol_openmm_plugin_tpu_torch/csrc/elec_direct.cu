// Direct-space PME electrostatics pair kernels for Hopper (sm_90a).
//
// K1 `fixed_field_kernel` replaces _fixed_field_kernel_tri (and, as a
// function, _fixed_field_kernel) of mbpol_openmm_plugin_tpu/ops/elec_pallas.py:
// the direct fixed charge field [N,3] and the full symmetric SCF factor
// matrices s3/s5 [N,N].
// K2 `direct_efp_kernel` replaces _pair_force_kernel_tri (and
// _pair_force_kernel): given the induced dipoles, the direct-space energy,
// the per-site pair force [N,3] and the per-site potential [N].
//
// Both run the per-pair chain of elec_pallas._pair_chain: minimum image,
// Ewald bn0..bn3 (erfcf from the CUDA math library in place of the
// Pallas _erfc fit) and the MB-pol Thole factors; the order-1 Thole factor
// uses the _H2_COEF fit of Q(3/4, y^4) exp(y^4) with the y <= 3.6 clamp
// (CUDA has no incomplete gamma).
//
// Bound on the H100: at water256 (N = 1024 sites) K1 must store s3 and s5,
// 2 x N^2 x 4 B = 8 MB, and both kernels evaluate ~0.4 N^2 in-cutoff pair
// chains (erfcf + 3-4 expf each). Design: one block per tile of kRows rows
// loops over every column; thread t handles columns j = t, t + 256, ... so
// the s3/s5 stores of neighbouring threads are neighbouring addresses and
// each column site is loaded once per block and reused for all kRows rows.
// Row sums stay in registers and are reduced inside the block (warp
// shuffles, then a fixed-order pass over the warps): no atomics, so the
// result is deterministic. Every pair chain is computed twice (for (i,j)
// and (j,i)); halving it with the i<->j symmetry is later work.
//
// Packed site layout [N, 8] float32: x, y, z, q, damping^(-1/6), molecule
// id, is-oxygen flag, unused. Columns are bound-checked against n (no
// padding). The C entry points take device pointers, sizes, the physics
// constants and the stream, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;
constexpr int kNS = 8;
constexpr float kSqrtPi = 1.7724538509055159f;
constexpr float kGamma34 = 1.2254167024651776f;

// H2(y) = Q(3/4, y^4) exp(y^4) on y in [0, 3.6] (elec_pallas._H2_COEF)
__constant__ float kH2[17] = {
    0.9999979243628037f, 0.00014319660928875655f, -0.0021470753751305915f,
    -1.0781905328873824f, 1.011730980379781f, -0.2717512876841842f,
    1.1463243006664783f, -3.2260426550515193f, 4.169189680278212f,
    -3.2744765067826873f, 1.7361138156847973f, -0.6471908493346308f,
    0.17102275603222306f, -0.03150024607180113f, 0.003856305471467913f,
    -0.0002825023639770407f, 9.381543447292913e-06f};

struct Consts {
  float alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz;
};

struct Site {
  float x, y, z, q, d16, mol, iso;
};

struct Pair {
  float dx, dy, dz;
  float bn0, bn1, bn2, bn3;
  float rr1, rr3, rr5, rr7;
  float s_cc1, s_cc3, s_cd3, s_cd5, s_dd3, s_dd5, s_dd7;
  bool same_mol;
};

__device__ __forceinline__ Site load_site(const float* __restrict__ sites, int j) {
  const float4* s4 = reinterpret_cast<const float4*>(sites);
  const float4 a = s4[2 * j];
  const float4 b = s4[2 * j + 1];
  return Site{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

__device__ __forceinline__ float min_image(float d, float b) {
  return d - floorf(d / b + 0.5f) * b;
}

__device__ __forceinline__ float h2_poly(float y) {
  float acc = kH2[16];
#pragma unroll
  for (int k = 15; k >= 0; --k) acc = acc * y + kH2[k];
  return acc;
}

// The pair chain for rows i and column j (i != j checked by the caller's
// indices). Returns false when the pair is outside the cutoff; kFull adds
// the quantities only K2 needs.
template <bool kFull>
__device__ __forceinline__ bool pair_chain(const Site& si, const Site& sj, int i, int j,
                                           const Consts& c, Pair& p) {
  if (i == j) return false;
  p.dx = min_image(sj.x - si.x, c.bx);
  p.dy = min_image(sj.y - si.y, c.by);
  p.dz = min_image(sj.z - si.z, c.bz);
  const float r = sqrtf(p.dx * p.dx + p.dy * p.dy + p.dz * p.dz);
  if (!(r * r <= c.cutoff2)) return false;
  const float inv_r = 1.0f / r;
  const float inv_r2 = inv_r * inv_r;

  // Ewald bn0..bn3 (ewaldScalingReal)
  const float ralpha = c.alpha * r;
  const float ex2 = expf(-ralpha * ralpha);
  const float alsq2 = 2.0f * c.alpha * c.alpha;
  const float f1 = alsq2 / (kSqrtPi * c.alpha);
  const float f2 = f1 * alsq2;
  p.bn0 = erfcf(ralpha) * inv_r;
  p.bn1 = (p.bn0 + f1 * ex2) * inv_r2;
  p.bn2 = (3.0f * p.bn1 + f2 * ex2) * inv_r2;
  p.rr1 = inv_r;
  p.rr3 = inv_r * inv_r2;
  p.rr5 = 3.0f * p.rr3 * inv_r2;

  // Thole damping (getAndScaleInverseRs)
  const float u = r * si.d16 * sj.d16;
  const float u4 = (u * u) * (u * u);
  p.same_mol = si.mol == sj.mol;
  const bool one_is_o = si.iso + sj.iso > 0.5f;
  const float gdd = p.same_mol ? (one_is_o ? c.g_ddoh : c.g_ddhh) : c.g_dd;
  const float ex_dd = expf(-gdd * u4);
  p.s_dd3 = 1.0f - ex_dd;
  p.s_dd5 = p.s_dd3 - (4.0f / 3.0f) * gdd * ex_dd * u4;
  const float ex_cc = expf(-c.g_cc * u4);
  p.s_cc3 = 1.0f - ex_cc;
  if (kFull) {
    const float f3 = f2 * alsq2;
    p.bn3 = (5.0f * p.bn2 + f3 * ex2) * inv_r2;
    p.rr7 = 15.0f * p.rr3 * inv_r2 * inv_r2;
    p.s_dd7 = p.s_dd5 - (4.0f / 15.0f) * gdd * (4.0f * gdd * u4 - 1.0f) * ex_dd * u4;
    const float g4 = sqrtf(sqrtf(c.g_cc));
    const float y = fminf(g4 * u, 3.6f);
    p.s_cc1 = p.s_cc3 + g4 * u * kGamma34 * h2_poly(y) * ex_cc;
    const float ex_cd = expf(-c.g_cd * u4);
    p.s_cd3 = 1.0f - ex_cd;
    p.s_cd5 = p.s_cd3 - (4.0f / 3.0f) * c.g_cd * ex_cd * u4;
  }
  return true;
}

// Sum acc[k] over the block's threads; thread k < K gets the total.
template <int K>
__device__ __forceinline__ void block_sum(float (&acc)[K], float (&red)[kWarps][K]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    acc[0] = s;
  }
}

__device__ __forceinline__ void load_rows(const float* __restrict__ sites, int n, int i0,
                                          Site (&rows)[kRows], float (&buf)[kRows][kNS]) {
  const int t = threadIdx.x;
  if (t < kRows * kNS) {
    const int r = t / kNS;
    buf[r][t % kNS] = (i0 + r < n) ? sites[(size_t)(i0 + r) * kNS + t % kNS] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    rows[r] = Site{buf[r][0], buf[r][1], buf[r][2], buf[r][3], buf[r][4], buf[r][5], buf[r][6]};
}

__global__ void __launch_bounds__(kThreads)
fixed_field_kernel(const float* __restrict__ sites, int n, Consts c,
                   float* __restrict__ field, float* __restrict__ s3,
                   float* __restrict__ s5) {
  __shared__ float buf[kRows][kNS];
  __shared__ float red[kWarps][kRows * 3];
  const int i0 = blockIdx.x * kRows;
  Site rows[kRows];
  load_rows(sites, n, i0, rows, buf);

  float acc[kRows * 3];
#pragma unroll
  for (int k = 0; k < kRows * 3; ++k) acc[k] = 0.0f;

  for (int j = threadIdx.x; j < n; j += kThreads) {
    const Site sj = load_site(sites, j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < n) {
        Pair p;
        float v3 = 0.0f, v5 = 0.0f;
        if (pair_chain<false>(rows[r], sj, i, j, c, p)) {
          // SCF factors (preFactor1/2)
          v3 = (1.0f - p.s_dd3) * p.rr3 - p.bn1;
          v5 = p.bn2 - (1.0f - p.s_dd5) * p.rr5;
          // fixed charge field; same-water pairs keep only the reciprocal
          // correction bn1 - rr3 (sign-fixed damping term, models/pme.py)
          const float s3cc = p.same_mol ? 0.0f : p.s_cc3;
          const float kq = (p.bn1 - (1.0f - s3cc) * p.rr3) * sj.q;
          acc[3 * r + 0] += kq * p.dx;
          acc[3 * r + 1] += kq * p.dy;
          acc[3 * r + 2] += kq * p.dz;
        }
        s3[(size_t)i * n + j] = v3;
        s5[(size_t)i * n + j] = v5;
      }
    }
  }
  block_sum<kRows * 3>(acc, red);
  const int t = threadIdx.x;
  if (t < kRows * 3 && i0 + t / 3 < n) field[(size_t)i0 * 3 + t] = -acc[0];
}

__global__ void __launch_bounds__(kThreads)
direct_efp_kernel(const float* __restrict__ sites, const float* __restrict__ mu, int n,
                  Consts c, float* __restrict__ force, float* __restrict__ pot,
                  float* __restrict__ e_row) {
  constexpr int kOut = 5;   // fx, fy, fz, pot, energy
  __shared__ float buf[kRows][kNS];
  __shared__ float mbuf[kRows][3];
  __shared__ float red[kWarps][kRows * kOut];
  const int i0 = blockIdx.x * kRows;
  const int t = threadIdx.x;
  if (t < kRows * 3) mbuf[t / 3][t % 3] = (i0 + t / 3 < n) ? mu[(size_t)i0 * 3 + t] : 0.0f;
  Site rows[kRows];
  load_rows(sites, n, i0, rows, buf);   // includes the __syncthreads for mbuf

  float acc[kRows * kOut];
#pragma unroll
  for (int k = 0; k < kRows * kOut; ++k) acc[k] = 0.0f;

  for (int j = t; j < n; j += kThreads) {
    const Site sj = load_site(sites, j);
    const float mxj = mu[3 * j], myj = mu[3 * j + 1], mzj = mu[3 * j + 2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      Pair p;
      if (i0 + r < n && pair_chain<true>(rows[r], sj, i0 + r, j, c, p)) {
        const float qi = rows[r].q, qj = sj.q;
        const float mxi = mbuf[r][0], myi = mbuf[r][1], mzi = mbuf[r][2];
        const float dot_i = mxi * p.dx + myi * p.dy + mzi * p.dz;   // mu_i . (r_j - r_i)
        const float dot_j = mxj * p.dx + myj * p.dy + mzj * p.dz;
        const float qq = qi * qj;
        const float gli1 = qj * dot_i - qi * dot_j;
        const float mumu = mxi * mxj + myi * myj + mzi * mzj;
        const float s1cc = p.same_mol ? 0.0f : p.s_cc1;
        const float s3cd = p.same_mol ? 0.0f : p.s_cd3;
        const float s3cc = p.same_mol ? 0.0f : p.s_cc3;
        const float s5cd = p.same_mol ? 0.0f : p.s_cd5;

        const float k1 = p.bn0 - p.rr1 * (1.0f - s1cc);
        const float w3 = p.bn1 - p.rr3 * (1.0f - s3cd);
        const float w5 = p.bn2 - p.rr5 * (1.0f - p.s_dd5);
        const float coeff = (p.bn1 - (1.0f - s3cc) * p.rr3) * qq
                            + (p.bn2 - p.rr5 * (1.0f - s5cd)) * gli1
                            + w5 * mumu
                            - (p.bn3 - p.rr7 * (1.0f - p.s_dd7)) * (dot_i * dot_j);
        float* a = acc + kOut * r;
        a[0] += coeff * p.dx + mxi * (w5 * dot_j) + (w5 * dot_i) * mxj + qi * (w3 * mxj) - mxi * (w3 * qj);
        a[1] += coeff * p.dy + myi * (w5 * dot_j) + (w5 * dot_i) * myj + qi * (w3 * myj) - myi * (w3 * qj);
        a[2] += coeff * p.dz + mzi * (w5 * dot_j) + (w5 * dot_i) * mzj + qi * (w3 * mzj) - mzi * (w3 * qj);
        a[3] += k1 * qj - w3 * dot_j;
        a[4] += 0.5f * (k1 * qq + 0.5f * w3 * gli1);
      }
    }
  }
  block_sum<kRows * kOut>(acc, red);
  if (t < kRows * kOut && i0 + t / kOut < n) {
    const int i = i0 + t / kOut, k = t % kOut;
    if (k < 3) force[(size_t)i * 3 + k] = acc[0];
    else if (k == 3) pot[i] = acc[0];
    else e_row[i] = acc[0];
  }
}

Consts make_consts(float alpha, float cutoff2, float g_cc, float g_cd, float g_dd,
                   float g_ddoh, float g_ddhh, float bx, float by, float bz) {
  return Consts{alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz};
}

}  // namespace

extern "C" int mbpol_fixed_field_scf(const float* sites, int n, float alpha, float cutoff2,
                                     float g_cc, float g_cd, float g_dd, float g_ddoh,
                                     float g_ddhh, float bx, float by, float bz,
                                     float* field, float* s3, float* s5, void* stream) {
  if (n <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const int blocks = (n + kRows - 1) / kRows;
  fixed_field_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, n, c, field, s3, s5);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_direct_efp(const float* sites, const float* mu, int n, float alpha,
                                float cutoff2, float g_cc, float g_cd, float g_dd,
                                float g_ddoh, float g_ddhh, float bx, float by, float bz,
                                float* force, float* pot, float* e_row, void* stream) {
  if (n <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const int blocks = (n + kRows - 1) / kRows;
  direct_efp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, mu, n, c, force, pot, e_row);
  return static_cast<int>(cudaGetLastError());
}
