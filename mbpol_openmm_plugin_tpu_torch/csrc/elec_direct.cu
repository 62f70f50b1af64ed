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
// Both run the per-pair chain of elec_common.cuh (elec_pallas._pair_chain),
// which the block-sparse kernels of elec_direct_bs.cu share.
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

#include "elec_common.cuh"

namespace {

using namespace mbpol;

constexpr int kRows = 4;

__global__ void __launch_bounds__(kThreads)
fixed_field_kernel(const float* __restrict__ sites, int n, Consts c,
                   float* __restrict__ field, float* __restrict__ s3,
                   float* __restrict__ s5) {
  __shared__ float buf[kRows][kNS];
  __shared__ float red[kWarps][kRows * 3];
  const int i0 = blockIdx.x * kRows;
  Site rows[kRows];
  load_rows<kRows>(sites, n, i0, rows, buf);

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
          scf_factors(p, v3, v5);
          const float kq = fixed_field_kq(p, sj.q);
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
  load_rows<kRows>(sites, n, i0, rows, buf);   // includes the __syncthreads for mbuf

  float acc[kRows * kOut];
#pragma unroll
  for (int k = 0; k < kRows * kOut; ++k) acc[k] = 0.0f;

  for (int j = t; j < n; j += kThreads) {
    const Site sj = load_site(sites, j);
    const float mj[3] = {mu[3 * j], mu[3 * j + 1], mu[3 * j + 2]};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      Pair p;
      if (i0 + r < n && pair_chain<true>(rows[r], sj, i0 + r, j, c, p))
        efp_pair(p, rows[r].q, sj.q, mbuf[r], mj, acc + kOut * r);
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
