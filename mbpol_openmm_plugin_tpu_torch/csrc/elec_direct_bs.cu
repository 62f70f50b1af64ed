// Block-sparse direct-space PME electrostatics kernels for Hopper (sm_90a),
// for boxes above the dense limit.
//
// The sites are sorted spatially and padded to a multiple of kTile = 256;
// a padded, row-major list of ACTIVE tile pairs (ti, tj, meta) names the
// [256 x 256] blocks whose bounding boxes come within the cutoff (built in
// ops/elec_direct_bs.py). The list holds both (I, J) and (J, I), so each
// row tile's partners form one consecutive run of the list, starting at
// row_start[I]. Padded list entries (meta VALID bit clear, parked on the
// last row tile) and padded sites (index >= n) contribute exactly zero.
//
// K1-bs `fixed_field_bs_kernel` replaces _fixed_field_bs_kernel of
// mbpol_openmm_plugin_tpu/ops/elec_pallas_bs.py: the fixed-field rows
// [np, 3] and the SCF factor blocks s3/s5 [cap, 256, 256] of the valid
// entries (the blocks of padded entries are left unwritten: K3-bs and
// every other reader skip them).
// K3-bs `scf_field_bs_kernel` replaces _scf_field_bs_kernel: one SCF dipole
// field evaluation, field_i = sum_j s3_ij mu_j + s5_ij (mu_j . d_ij) d_ij
// over the active blocks, recomputing only the minimum-image d_ij.
// K2-bs `direct_efp_bs_kernel` replaces _pair_force_bs_kernel: per-row
// force [np, 3], potential [np] and half pair-energy sums [np] given the
// induced dipoles.
// All three run the pair chain of elec_common.cuh, as the dense kernels do.
//
// Bound on the H100 (water4096: 16,384 sites, 64 row tiles, ~3700 active
// blocks): K1-bs must store s3 and s5, 2 x n_act x 256 KB ~ 1.9 GB, and
// K3-bs must read them back on every SCF field evaluation; both are bound by
// device-memory bytes. K2-bs moves O(N) bytes and is bound by the pair
// chains it evaluates (erfcf + 4 expf per in-cutoff pair).
//
// Design: rows, not tile pairs, own blocks. One CUDA block of 256 threads
// owns kRows consecutive rows of one row tile and loops over that row
// tile's run of the list; thread t takes column t of each column tile, so
// the s3/s5 stores (K1-bs) and loads (K3-bs) of neighbouring threads are
// neighbouring addresses, and each column site is loaded once per block
// for all kRows rows. Row sums stay in registers and are reduced inside
// the block in a fixed order: no atomics and no cross-block accumulation,
// so results are the same bits on every run. 64 row tiles x 64 blocks
// each = 4096 blocks at water4096. Block offsets are size_t
// (cap x 65536 passes 2^31 at larger boxes).
//
// The C entry points take device pointers, sizes, the physics constants
// and the stream, allocate nothing and return cudaGetLastError().

#include "elec_common.cuh"

namespace {

using namespace mbpol;

constexpr int kTile = 256;
constexpr int kRows = 4;
constexpr int kSub = kTile / kRows;      // blocks per row tile
constexpr int kValid = 1;                // meta bit flags (elec_pallas_bs)
constexpr size_t kBlock = (size_t)kTile * kTile;

static_assert(kThreads == kTile, "one thread per column of a column tile");

__device__ __forceinline__ int row_tile() { return blockIdx.x / kSub; }
__device__ __forceinline__ int first_row() {
  return row_tile() * kTile + (blockIdx.x % kSub) * kRows;
}

__global__ void __launch_bounds__(kThreads)
fixed_field_bs_kernel(const float* __restrict__ sites, int n, const int* __restrict__ tj,
                      const int* __restrict__ meta, const int* __restrict__ row_start,
                      Consts c, float* __restrict__ field, float* __restrict__ s3,
                      float* __restrict__ s5) {
  __shared__ float buf[kRows][kNS];
  __shared__ float red[kWarps][kRows * 3];
  const int i0 = first_row();
  const int t = threadIdx.x;
  Site rows[kRows];
  load_rows<kRows>(sites, n, i0, rows, buf);

  float acc[kRows * 3];
#pragma unroll
  for (int k = 0; k < kRows * 3; ++k) acc[k] = 0.0f;

  const size_t rloc = (size_t)(i0 % kTile) * kTile + t;
  const int p_end = row_start[row_tile() + 1];
  for (int p = row_start[row_tile()]; p < p_end; ++p) {
    if (!(meta[p] & kValid)) continue;
    float* __restrict__ s3p = s3 + (size_t)p * kBlock + rloc;
    float* __restrict__ s5p = s5 + (size_t)p * kBlock + rloc;
    const int j = tj[p] * kTile + t;
    const Site sj = load_site(sites, j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      Pair pr;
      float v3 = 0.0f, v5 = 0.0f;
      if (i < n && j < n && pair_chain<false>(rows[r], sj, i, j, c, pr)) {
        scf_factors(pr, v3, v5);
        const float kq = fixed_field_kq(pr, sj.q);
        acc[3 * r + 0] += kq * pr.dx;
        acc[3 * r + 1] += kq * pr.dy;
        acc[3 * r + 2] += kq * pr.dz;
      }
      s3p[r * kTile] = v3;
      s5p[r * kTile] = v5;
    }
  }
  block_sum<kRows * 3>(acc, red);
  if (t < kRows * 3) field[(size_t)i0 * 3 + t] = -acc[0];
}

__global__ void __launch_bounds__(kThreads)
scf_field_bs_kernel(const float* __restrict__ sites, const float* __restrict__ mu,
                    const int* __restrict__ tj, const int* __restrict__ meta,
                    const int* __restrict__ row_start, Consts c,
                    const float* __restrict__ s3, const float* __restrict__ s5,
                    float* __restrict__ field) {
  __shared__ float pbuf[kRows][3];
  __shared__ float red[kWarps][kRows * 3];
  const int i0 = first_row();
  const int t = threadIdx.x;
  if (t < kRows * 3) pbuf[t / 3][t % 3] = sites[(size_t)(i0 + t / 3) * kNS + t % 3];
  __syncthreads();

  float acc[kRows * 3];
#pragma unroll
  for (int k = 0; k < kRows * 3; ++k) acc[k] = 0.0f;

  const size_t rloc = (size_t)(i0 % kTile) * kTile + t;
  const int p_end = row_start[row_tile() + 1];
  for (int p = row_start[row_tile()]; p < p_end; ++p) {
    if (!(meta[p] & kValid)) continue;
    const int j = tj[p] * kTile + t;
    const float4 pj = reinterpret_cast<const float4*>(sites)[2 * (size_t)j];
    const float mj[3] = {mu[3 * (size_t)j], mu[3 * (size_t)j + 1], mu[3 * (size_t)j + 2]};
    const float* __restrict__ s3p = s3 + (size_t)p * kBlock + rloc;
    const float* __restrict__ s5p = s5 + (size_t)p * kBlock + rloc;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float d[3] = {min_image(pj.x - pbuf[r][0], c.bx), min_image(pj.y - pbuf[r][1], c.by),
                          min_image(pj.z - pbuf[r][2], c.bz)};
      const float v3 = s3p[r * kTile];
      const float s5proj = s5p[r * kTile] * (mj[0] * d[0] + mj[1] * d[1] + mj[2] * d[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[3 * r + k] += v3 * mj[k] + s5proj * d[k];
    }
  }
  block_sum<kRows * 3>(acc, red);
  if (t < kRows * 3) field[(size_t)i0 * 3 + t] = acc[0];
}

__global__ void __launch_bounds__(kThreads)
direct_efp_bs_kernel(const float* __restrict__ sites, const float* __restrict__ mu, int n,
                     const int* __restrict__ tj, const int* __restrict__ meta,
                     const int* __restrict__ row_start, Consts c, float* __restrict__ force,
                     float* __restrict__ pot, float* __restrict__ e_row) {
  constexpr int kOut = 5;   // fx, fy, fz, pot, energy
  __shared__ float buf[kRows][kNS];
  __shared__ float mbuf[kRows][3];
  __shared__ float red[kWarps][kRows * kOut];
  const int i0 = first_row();
  const int t = threadIdx.x;
  if (t < kRows * 3) mbuf[t / 3][t % 3] = mu[(size_t)i0 * 3 + t];
  Site rows[kRows];
  load_rows<kRows>(sites, n, i0, rows, buf);   // includes the __syncthreads for mbuf

  float acc[kRows * kOut];
#pragma unroll
  for (int k = 0; k < kRows * kOut; ++k) acc[k] = 0.0f;

  const int p_end = row_start[row_tile() + 1];
  for (int p = row_start[row_tile()]; p < p_end; ++p) {
    if (!(meta[p] & kValid)) continue;
    const int j = tj[p] * kTile + t;
    if (j >= n) continue;
    const Site sj = load_site(sites, j);
    const float mj[3] = {mu[3 * (size_t)j], mu[3 * (size_t)j + 1], mu[3 * (size_t)j + 2]};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      Pair pr;
      if (i0 + r < n && pair_chain<true>(rows[r], sj, i0 + r, j, c, pr))
        efp_pair(pr, rows[r].q, sj.q, mbuf[r], mj, acc + kOut * r);
    }
  }
  block_sum<kRows * kOut>(acc, red);
  if (t < kRows * kOut) {
    const size_t i = (size_t)i0 + t / kOut;
    const int k = t % kOut;
    if (k < 3) force[i * 3 + k] = acc[0];
    else if (k == 3) pot[i] = acc[0];
    else e_row[i] = acc[0];
  }
}

}  // namespace

extern "C" int mbpol_fixed_field_scf_bs(const float* sites, int n, int n_tiles, const int* tj,
                                        const int* meta, const int* row_start, float alpha,
                                        float cutoff2, float g_cc, float g_cd, float g_dd,
                                        float g_ddoh, float g_ddhh, float bx, float by,
                                        float bz, float* field, float* s3, float* s5,
                                        void* stream) {
  if (n_tiles <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  fixed_field_bs_kernel<<<n_tiles * kSub, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, n, tj, meta, row_start, c, field, s3, s5);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_scf_field_bs(const float* sites, const float* mu, int n_tiles,
                                  const int* tj, const int* meta, const int* row_start,
                                  float alpha, float cutoff2, float g_cc, float g_cd,
                                  float g_dd, float g_ddoh, float g_ddhh, float bx, float by,
                                  float bz, const float* s3, const float* s5, float* field,
                                  void* stream) {
  if (n_tiles <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  scf_field_bs_kernel<<<n_tiles * kSub, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, mu, tj, meta, row_start, c, s3, s5, field);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_direct_efp_bs(const float* sites, const float* mu, int n, int n_tiles,
                                   const int* tj, const int* meta, const int* row_start,
                                   float alpha, float cutoff2, float g_cc, float g_cd,
                                   float g_dd, float g_ddoh, float g_ddhh, float bx, float by,
                                   float bz, float* force, float* pot, float* e_row,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  direct_efp_bs_kernel<<<n_tiles * kSub, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, mu, n, tj, meta, row_start, c, force, pot, e_row);
  return static_cast<int>(cudaGetLastError());
}
