// The per-pair chain of the direct-space PME electrostatics, shared by the
// dense kernels (elec_direct.cu) and the block-sparse kernels
// (elec_direct_bs.cu), so that both run one set of formulas.
//
// It is the chain of mbpol_openmm_plugin_tpu/ops/elec_pallas._pair_chain:
// minimum image, Ewald bn0..bn3 (erfcf from the CUDA math library in place
// of the Pallas _erfc fit) and the MB-pol Thole factors; the order-1 Thole
// factor uses the _H2_COEF fit of Q(3/4, y^4) exp(y^4) with the y <= 3.6
// clamp (CUDA has no incomplete gamma).
//
// Packed site layout [N, 8] float32: x, y, z, q, damping^(-1/6), molecule
// id, is-oxygen flag, unused.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mbpol {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNS = 8;
constexpr float kSqrtPi = 1.7724538509055159f;
constexpr float kGamma34 = 1.2254167024651776f;
// the loosened cutoff^2 factor of the kernels' r^2 pre-test (no division,
// no sqrtf), which the exact test of pair_chain then decides
constexpr float kLoose = 1.0001f;

// H2(y) = Q(3/4, y^4) exp(y^4) on y in [0, 3.6] (elec_pallas._H2_COEF);
// static: each translation unit holds its own copy
static __constant__ float kH2[17] = {
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

inline Consts make_consts(float alpha, float cutoff2, float g_cc, float g_cd, float g_dd,
                          float g_ddoh, float g_ddhh, float bx, float by, float bz) {
  return Consts{alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz};
}

__device__ __forceinline__ Site load_site(const float* __restrict__ sites, int j) {
  const float4* s4 = reinterpret_cast<const float4*>(sites);
  const float4 a = s4[2 * (size_t)j];
  const float4 b = s4[2 * (size_t)j + 1];
  return Site{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

__device__ __forceinline__ float min_image(float d, float b) {
  return d - floorf(d / b + 0.5f) * b;
}

// The minimum image with a multiply by 1/b in place of the division: the
// same image as min_image, so the same bits, except where d / b + 1/2
// rounds to another integer, and there either image is about half a box
// away. So it serves the r^2 pre-tests (a loose margin makes them safe),
// and the values summed over the pairs inside a cutoff shorter than half
// the box (the minimum-image convention): no such pair sits half a box
// away, so each gets min_image's bits.
__device__ __forceinline__ float min_image_fast(float d, float b, float inv_b) {
  return d - floorf(d * inv_b + 0.5f) * b;
}

// Pair-independent constants of the chain, computed once per thread.
struct Derived {
  float f1, f2, f3, g4, ibx, iby, ibz;
};

__device__ __forceinline__ Derived derive(const Consts& c) {
  const float alsq2 = 2.0f * c.alpha * c.alpha;
  const float f1 = alsq2 / (kSqrtPi * c.alpha);
  const float f2 = f1 * alsq2;
  return Derived{f1, f2, f2 * alsq2, sqrtf(sqrtf(c.g_cc)), 1.0f / c.bx, 1.0f / c.by,
                 1.0f / c.bz};
}

__device__ __forceinline__ float h2_poly(float y) {
  float acc = kH2[16];
#pragma unroll
  for (int k = 15; k >= 0; --k) acc = acc * y + kH2[k];
  return acc;
}

// The pair chain for row site i and column site j (global indices; the
// caller masks padded sites). Returns false for i == j and for pairs
// outside the cutoff; kFull adds the quantities only K2 needs. kFastImage
// takes the minimum image by 1/box (min_image_fast): the image differs from
// min_image's only where an axis component is half a box long, beyond the
// cutoff, so every pair inside it gets the same bits.
template <bool kFull, bool kFastImage = false>
__device__ __forceinline__ bool pair_chain(const Site& si, const Site& sj, int i, int j,
                                           const Consts& c, const Derived& k, Pair& p) {
  if (i == j) return false;
  if (kFastImage) {
    p.dx = min_image_fast(sj.x - si.x, c.bx, k.ibx);
    p.dy = min_image_fast(sj.y - si.y, c.by, k.iby);
    p.dz = min_image_fast(sj.z - si.z, c.bz, k.ibz);
  } else {
    p.dx = min_image(sj.x - si.x, c.bx);
    p.dy = min_image(sj.y - si.y, c.by);
    p.dz = min_image(sj.z - si.z, c.bz);
  }
  const float r = sqrtf(p.dx * p.dx + p.dy * p.dy + p.dz * p.dz);
  if (!(r * r <= c.cutoff2)) return false;
  const float inv_r = 1.0f / r;
  const float inv_r2 = inv_r * inv_r;

  // Ewald bn0..bn3 (ewaldScalingReal)
  const float ralpha = c.alpha * r;
  const float ex2 = expf(-ralpha * ralpha);
  p.bn0 = erfcf(ralpha) * inv_r;
  p.bn1 = (p.bn0 + k.f1 * ex2) * inv_r2;
  p.bn2 = (3.0f * p.bn1 + k.f2 * ex2) * inv_r2;
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
    p.bn3 = (5.0f * p.bn2 + k.f3 * ex2) * inv_r2;
    p.rr7 = 15.0f * p.rr3 * inv_r2 * inv_r2;
    p.s_dd7 = p.s_dd5 - (4.0f / 15.0f) * gdd * (4.0f * gdd * u4 - 1.0f) * ex_dd * u4;
    const float y = fminf(k.g4 * u, 3.6f);
    p.s_cc1 = p.s_cc3 + k.g4 * u * kGamma34 * h2_poly(y) * ex_cc;
    const float ex_cd = expf(-c.g_cd * u4);
    p.s_cd3 = 1.0f - ex_cd;
    p.s_cd5 = p.s_cd3 - (4.0f / 3.0f) * c.g_cd * ex_cd * u4;
  }
  return true;
}

// SCF factors of one in-cutoff pair (preFactor1/2): s3, s5.
__device__ __forceinline__ void scf_factors(const Pair& p, float& v3, float& v5) {
  v3 = (1.0f - p.s_dd3) * p.rr3 - p.bn1;
  v5 = p.bn2 - (1.0f - p.s_dd5) * p.rr5;
}

// Fixed-field coupling of one in-cutoff pair times q_j: same-water pairs
// keep only the reciprocal correction bn1 - rr3 (the sign-fixed damping
// term of models/pme.py).
__device__ __forceinline__ float fixed_field_kq(const Pair& p, float qj) {
  const float s3cc = p.same_mol ? 0.0f : p.s_cc3;
  return (p.bn1 - (1.0f - s3cc) * p.rr3) * qj;
}

// K2's per-pair contributions to row i: force (a[0..2]), potential (a[3])
// and half the pair energy (a[4]), given mu_i (mi) and mu_j (mj).
__device__ __forceinline__ void efp_pair(const Pair& p, float qi, float qj, const float* mi,
                                         const float* mj, float* a) {
  const float dot_i = mi[0] * p.dx + mi[1] * p.dy + mi[2] * p.dz;   // mu_i . (r_j - r_i)
  const float dot_j = mj[0] * p.dx + mj[1] * p.dy + mj[2] * p.dz;
  const float qq = qi * qj;
  const float gli1 = qj * dot_i - qi * dot_j;
  const float mumu = mi[0] * mj[0] + mi[1] * mj[1] + mi[2] * mj[2];
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
  const float d[3] = {p.dx, p.dy, p.dz};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    a[k] += coeff * d[k] + mi[k] * (w5 * dot_j) + (w5 * dot_i) * mj[k] + qi * (w3 * mj[k])
            - mi[k] * (w3 * qj);
  a[3] += k1 * qj - w3 * dot_j;
  a[4] += 0.5f * (k1 * qq + 0.5f * w3 * gli1);
}

// The column side of K2's potential for one in-cutoff pair: site j's
// potential from q_i and mu_i (mi), the i<->j swap of efp_pair's a[3]
// (d -> -d), with efp_pair's k1 and w3.
__device__ __forceinline__ float efp_pot_col(const Pair& p, float qi, const float* mi) {
  const float dot_i = mi[0] * p.dx + mi[1] * p.dy + mi[2] * p.dz;   // mu_i . (r_j - r_i)
  const float s1cc = p.same_mol ? 0.0f : p.s_cc1;
  const float s3cd = p.same_mol ? 0.0f : p.s_cd3;
  const float k1 = p.bn0 - p.rr1 * (1.0f - s1cc);
  const float w3 = p.bn1 - p.rr3 * (1.0f - s3cd);
  return k1 * qi + w3 * dot_i;
}

// Sum acc[k] over the block's threads; thread k < K gets the total in
// acc[0]. Warp shuffles, then a fixed-order pass over the warps: no
// atomics, so the result is the same bits on every run.
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

// Load kRows consecutive row sites starting at i0 (rows >= n read as zero)
// through shared memory; ends with a __syncthreads.
template <int kRows>
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

}  // namespace mbpol
