// Direct-space PME electrostatics pair kernels for Hopper (sm_90a), the
// dense path (models/potential.py keeps it up to DENSE_LIMIT_KERNELS waters).
//
// K1 `fixed_field_tri_kernel` replaces _fixed_field_kernel_tri (and, as a
// function, _fixed_field_kernel) of mbpol_openmm_plugin_tpu/ops/elec_pallas.py:
// the direct fixed charge field [N,3] and the full symmetric SCF factor
// matrices s3/s5 [N,N].
// K2 `direct_efp_tri_kernel` replaces _pair_force_kernel_tri (and
// _pair_force_kernel): given the induced dipoles, the direct-space energy,
// the per-site pair force [N,3] and the per-site potential [N].
// `tile_sum_kernel`, launched after each, adds up their per-tile partials.
// All run the per-pair chain of elec_common.cuh (elec_pallas._pair_chain),
// which the block-sparse kernels of elec_direct_bs.cu share.
//
// Bound on the H100: K1 must store s3 and s5, 2 x N^2 x 4 B (8.4 MB at
// water256, N = 1024 sites; 537 MB at water2048, N = 8192), and both need
// the chain (sqrtf, 1/r, erfcf, 3-4 expf) of each unordered in-cutoff pair
// once: ~41% of the pairs at water256, ~5% at water2048.
//
// Design: the triangular form of the TPU kernels. The sites are cut into
// tiles of kTile (the last one ragged); one block of kTriThreads takes one
// tile pair ti <= tj (`tile_pair`: the folded order, where each run of
// n_tiles + 1 blocks holds row tiles r and n_tiles - 1 - r, the same work),
// so each unordered pair's chain runs once; a diagonal tile takes r < c.
// Warp w tests its band of kBand rows against the tile's columns on r^2
// alone (minimum image by 1/box against a loosened cutoff^2: no division,
// no sqrtf); the block lists the survivors row-major in shared memory and
// its warps run the exact test and chain of 32 of them per pass, so the
// lanes run useful chains although most candidates lie outside the cutoff
// (~59% at water256, ~95% at water2048). A lane writes its pair's results
// into shared [kTile x kTile] planes at (r, c), and a bit mask per row and
// per column marks the listed pairs. Each row's sums (over c) and each
// column's sums (over r) then run over the set bits in index order, in
// kSplit parts added in order: the order is fixed by the indices alone, not
// by which lane ran which chain, so every run gives the same bits. The
// column side is the TPU kernels' i<->j swap (d -> -d, dot_i -> -dot_j,
// dot_j -> -dot_i; every scale factor symmetric): K1's field_j gets
// +q_i kdir d, K2's force_j is -force_i, its pot_j is k1 q_i + w3 dot_i, and
// the pair energy is counted once, on the row side. A block writes the row
// sums into the slot of partner tile tj and the column sums into that of
// ti, so each (tile, site) slot of the [n_tiles, K, N] scratch is written
// by exactly one block (a diagonal tile adds its row and column sums
// first), with no atomics; tile_sum_kernel adds the n_tiles slots of each
// (component, site) in a fixed order (tile groups, then the groups).
// K1's s3/s5 planes start as zeros; it stores tile (ti, tj) of s3/s5 from
// the planes' rows and tile (tj, ti) from their columns (pitch kTile + 1:
// no bank conflicts), four columns a thread as 16-byte stores, so every
// entry is written once: exact zeros outside the cutoff and on the
// diagonal, and s3 = s3^T, s5 = s5^T bit for bit.
// The pair-independent constants are computed once per thread (Derived),
// and the exact chain takes the minimum image by 1/box (pair_chain's
// kFastImage: the same bits for every pair inside the cutoff).
//
// Packed site layout [N, 8] float32: x, y, z, q, damping^(-1/6), molecule
// id, is-oxygen flag, unused. Sites at or past n are bound-checked (no
// padding). The C entry points take device pointers, sizes, the physics
// constants, the partials scratch and the stream, allocate nothing and
// return cudaGetLastError().

#include "elec_common.cuh"

namespace {

using namespace mbpol;

constexpr int kTile = 32;                     // sites per tile
constexpr int kTriThreads = 128;              // threads per tile pair
constexpr int kTriWarps = kTriThreads / 32;
constexpr int kBand = kTile / kTriWarps;      // rows a warp tests
constexpr int kPitch = kTile + 1;             // shared plane row pitch
constexpr int kSitePitch = kNS + 1;           // shared site row pitch (no bank conflicts)
constexpr int kSplit = kTriThreads / (2 * kTile);   // threads per row (column) sum
constexpr int kSumGroups = 8;                 // tile groups of tile_sum_kernel, a warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOutK1 = 3;                     // field
constexpr int kOutK2 = 5;                     // force x/y/z, potential, pair energy

static_assert(kTile == 32, "a lane per column of the tile; row and column masks are 32-bit words");
static_assert(kTile % kTriWarps == 0 && kSplit >= 1 && kTile % kSplit == 0,
              "whole bands; whole parts of a row (column) per summing thread");

// Shared memory of one tile pair: kPlanes result planes, the row and column
// sites (and dipoles), the row and column masks and the list of the pairs
// that passed the r^2 test, and the parts of the row and column sums.
template <int kPlanes, int kOut>
struct TileSmem {
  float plane[kPlanes][kTile][kPitch];
  float row[kTile][kSitePitch];
  float col[kTile][kSitePitch];
  float mrow[kTile][3];
  float mcol[kTile][3];
  float sums[2][kSplit][kOut][kTile];          // row / column sums, by part
  unsigned rmask[kTile];                      // bit c: pair (r, c) listed
  unsigned cpart[kTriWarps][kTile];           // bit r: the same, per warp's band
  unsigned short list[kTile * kTile];         // listed pairs r * kTile + c, row-major
  int count[kTriWarps];                       // listed pairs per warp's band
};

// The tile pair of block p in the folded order: run r of n_tiles + 1 blocks
// holds row tile r's pairs (r, r .. nt - 1), then row tile nt - 1 - r's
// (nt - 1 - r .. nt - 1) (ops/elec_direct.tile_pairs mirrors it).
__device__ __forceinline__ void tile_pair(int p, int nt, int& ti, int& tj) {
  const int r = p / (nt + 1), c = p % (nt + 1);
  if (c < nt - r) {
    ti = r;
    tj = r + c;
  } else {
    ti = nt - 1 - r;
    tj = ti + c - (nt - r);
  }
}

__device__ __forceinline__ Site smem_site(const float (&s)[kSitePitch]) {
  return Site{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
}

// Row tile sites at i0 and column tile sites at j0 into shared memory
// (sites at or past n read as zero), and their dipoles when mu is given:
// every global load is issued before the shared stores.
template <class Smem>
__device__ __forceinline__ void load_tiles(const float* __restrict__ sites,
                                           const float* __restrict__ mu, int n, int i0, int j0,
                                           Smem& s) {
  constexpr int kSiteLoads = (4 * kTile + kTriThreads - 1) / kTriThreads;
  constexpr int kMuLoads = (6 * kTile + kTriThreads - 1) / kTriThreads;
  const float4* s4 = reinterpret_cast<const float4*>(sites);
  float4 v[kSiteLoads];
  float m[kMuLoads];
#pragma unroll
  for (int a = 0; a < kSiteLoads; ++a) {
    const int q = threadIdx.x + a * kTriThreads;
    const int u = q % (2 * kTile), g = (q >= 2 * kTile ? j0 : i0) + u / 2;
    v[a] = q < 4 * kTile && g < n ? s4[2 * (size_t)g + u % 2]
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int a = 0; a < kMuLoads; ++a) {
    const int q = threadIdx.x + a * kTriThreads;
    const int u = q % (3 * kTile), g = (q >= 3 * kTile ? j0 : i0) + u / 3;
    m[a] = mu != nullptr && q < 6 * kTile && g < n ? mu[3 * (size_t)g + u % 3] : 0.0f;
  }
#pragma unroll
  for (int a = 0; a < kSiteLoads; ++a) {
    const int q = threadIdx.x + a * kTriThreads;
    if (q < 4 * kTile) {
      const int u = q % (2 * kTile);
      float* dst = &(q >= 2 * kTile ? s.col : s.row)[u / 2][4 * (u % 2)];
      dst[0] = v[a].x;
      dst[1] = v[a].y;
      dst[2] = v[a].z;
      dst[3] = v[a].w;
    }
  }
#pragma unroll
  for (int a = 0; a < kMuLoads; ++a) {
    const int q = threadIdx.x + a * kTriThreads;
    if (q < 6 * kTile) {
      const int u = q % (3 * kTile);
      (q >= 3 * kTile ? s.mcol : s.mrow)[u / 3][u % 3] = m[a];
    }
  }
  __syncthreads();
}

// Warp w tests rows w * kBand .. + kBand - 1 against the tile's columns
// (loosened r^2; r < c in a diagonal tile; sites past n rejected) and sets
// rmask for its rows and cpart[w] for every column. The block then lists
// the survivors row-major, and warp w runs run(r, c) on the list's chunks
// of 32 pairs w, w + kTriWarps, ... Ends with a __syncthreads.
template <class Smem, class Run>
__device__ __forceinline__ void run_pairs(Smem& s, int i0, int j0, int n, bool diag,
                                          const Consts& c, const Derived& k, Run run) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float loose2 = kLoose * c.cutoff2;
  unsigned bits[kBand];
  int count = 0;
  const float cx = s.col[lane][0], cy = s.col[lane][1], cz = s.col[lane][2];
  const bool col_ok = j0 + lane < n;
  unsigned cb = 0;
#pragma unroll
  for (int b = 0; b < kBand; ++b) {
    const int r = w * kBand + b;
    const float dx = min_image_fast(cx - s.row[r][0], c.bx, k.ibx);
    const float dy = min_image_fast(cy - s.row[r][1], c.by, k.iby);
    const float dz = min_image_fast(cz - s.row[r][2], c.bz, k.ibz);
    const bool keep = dx * dx + dy * dy + dz * dz <= loose2 && col_ok && i0 + r < n
                      && (!diag || r < lane);
    bits[b] = __ballot_sync(kFull, keep);
    cb |= (unsigned)keep << b;
    count += __popc(bits[b]);
  }
  s.cpart[w][lane] = cb << (w * kBand);
  if (lane < kBand) {
    unsigned m = 0;
#pragma unroll
    for (int b = 0; b < kBand; ++b)
      if (b == lane) m = bits[b];
    s.rmask[w * kBand + lane] = m;
  }
  if (lane == 0) s.count[w] = count;
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int v = 0; v < kTriWarps; ++v) {
    off += v < w ? s.count[v] : 0;
    total += s.count[v];
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int b = 0; b < kBand; ++b) {
    if ((bits[b] >> lane) & 1u)
      s.list[off + __popc(bits[b] & below)] = (unsigned short)((w * kBand + b) * kTile + lane);
    off += __popc(bits[b]);
  }
  __syncthreads();
  for (int p = 32 * w + lane; p < total; p += kTriThreads) {
    const unsigned e = s.list[p];
    run(e / kTile, e % kTile);
  }
  __syncthreads();
}

// Row and column sums of the tile: thread t takes part t / kTile %
// kSplit (its kTile / kSplit columns, or rows) of row t % kTile (t <
// kTriThreads / 2) or column t % kTile, calling add(on, is_row, r, c, f)
// in index order, on for the listed pairs (add adds nothing for the
// others, whose planes hold no values): over the listed pairs alone
// (kWalkBits), or over every index of the part, which lets the loads of
// the next indices go ahead (K1 at water256: 0.0073 against 0.0078 ms; K2,
// with more planes to load, gains more from skipping: 0.164 against 0.182
// ms at water2048). Then finish(is_row, f) fixes the signs, and the parts
// are added in order. Writes the row sums into the
// slot of partner tile tj and the column sums into that of ti, in the
// partials [nt, kOut, n]; a diagonal tile adds each site's row and column
// sums first, in that order.
template <int kOut, bool kWalkBits, class Smem, class Add, class Finish>
__device__ __forceinline__ void sum_tile(Smem& s, int ti, int tj, int n, bool diag,
                                         float* __restrict__ part, Add add, Finish finish) {
  constexpr int kPart = kTile / kSplit;
  const int t = threadIdx.x;
  const bool is_row = t < kTriThreads / 2;
  const int u = t % (kTriThreads / 2), x = u % kTile, q0 = (u / kTile) * kPart;
  unsigned m = 0;
  if (is_row) {
    m = s.rmask[x];
  } else {
#pragma unroll
    for (int w = 0; w < kTriWarps; ++w) m |= s.cpart[w][x];
  }
  float f[kOut];
#pragma unroll
  for (int q = 0; q < kOut; ++q) f[q] = 0.0f;
  if constexpr (kWalkBits) {
    if constexpr (kPart < 32) m &= ((1u << kPart) - 1u) << q0;
    while (m) {
      const int y = __ffs(m) - 1;
      m &= m - 1;
      add(true, is_row, is_row ? x : y, is_row ? y : x, f);
    }
  } else {
#pragma unroll 8
    for (int y = q0; y < q0 + kPart; ++y)
      add((m >> y) & 1u, is_row, is_row ? x : y, is_row ? y : x, f);
  }
  finish(is_row, f);
#pragma unroll
  for (int q = 0; q < kOut; ++q) s.sums[is_row ? 0 : 1][u / kTile][q][x] = f[q];
  __syncthreads();
  if (t < 2 * kTile && (!diag || t < kTile)) {
    const int side = t / kTile, y = t % kTile;
    const int site = (side == 0 ? ti : tj) * kTile + y;
    const int slot = side == 0 ? tj : ti;
    if (site < n) {
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        float v = 0.0f;
#pragma unroll
        for (int a = 0; a < kSplit; ++a) v += s.sums[side][a][q][y];
        if (diag) {
          float vc = 0.0f;
#pragma unroll
          for (int a = 0; a < kSplit; ++a) vc += s.sums[1][a][q][y];
          v += vc;
        }
        part[((size_t)slot * kOut + q) * n + site] = v;
      }
    }
  }
}

// Store v[0 .. 3] at out[row, col .. col + 3] of an [n, n] matrix: one
// 16-byte store where the row allows it (n % 4 == 0, col % 4 == 0), else
// entry by entry; entries at or past n are skipped.
__device__ __forceinline__ void store4(float* __restrict__ out, int n, int row, int col,
                                      const float (&v)[4]) {
  if (row >= n) return;
  float* __restrict__ p = out + (size_t)row * n + col;
  if ((n & 3) == 0 && col + 3 < n) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (col + q < n) p[q] = v[q];
}

using SmemK1 = TileSmem<5, kOutK1>;   // planes: s3, s5, kdir d (x, y, z)
using SmemK2 = TileSmem<6, kOutK2>;   // planes: force on i (x, y, z), pot_i, pot_j, e_pair

__global__ void __launch_bounds__(kTriThreads)
fixed_field_tri_kernel(const float* __restrict__ sites, int n, int nt, Consts c,
                       float* __restrict__ part, float* __restrict__ s3,
                       float* __restrict__ s5) {
  __shared__ __align__(16) SmemK1 s;
  int ti, tj;
  tile_pair(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  // s3/s5 planes start as zeros: the pairs never listed are stored as such
  for (int q = threadIdx.x; q < 2 * kTile * kPitch / 4; q += kTriThreads)
    reinterpret_cast<float4*>(&s.plane[0][0][0])[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  load_tiles(sites, nullptr, n, i0, j0, s);
  const Derived k = derive(c);

  run_pairs(s, i0, j0, n, diag, c, k, [&](int r, int cc) {
    const Site si = smem_site(s.row[r]), sj = smem_site(s.col[cc]);
    Pair p;
    float v3 = 0.0f, v5 = 0.0f, kd = 0.0f;
    if (pair_chain<false, true>(si, sj, i0 + r, j0 + cc, c, k, p)) {
      scf_factors(p, v3, v5);
      kd = fixed_field_kq(p, 1.0f);         // the coupling without the charge
    }
    s.plane[0][r][cc] = v3;
    s.plane[1][r][cc] = v5;
    s.plane[2][r][cc] = kd * p.dx;
    s.plane[3][r][cc] = kd * p.dy;
    s.plane[4][r][cc] = kd * p.dz;
  });

  // field: row i gets -q_j kdir d, column j gets +q_i kdir d
  sum_tile<kOutK1, false>(
      s, ti, tj, n, diag, part,
      [&](bool on, bool is_row, int r, int cc, float (&f)[kOutK1]) {
        const float q = is_row ? s.col[cc][3] : s.row[r][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float v = s.plane[2 + a][r][cc];
          if (on) f[a] += q * v;
        }
      },
      [](bool is_row, float (&f)[kOutK1]) {
        if (is_row) {
#pragma unroll
          for (int a = 0; a < 3; ++a) f[a] = -f[a];
        }
      });

  // s3/s5, four columns a thread: tile (ti, tj) from the planes' rows and
  // (tj, ti) from their columns; a diagonal tile's entry (a, b) is U[a][b] +
  // U[b][a], one of them the zero of the fill
  for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += kTriThreads) {
    const int a = idx / (kTile / 4), b = 4 * (idx % (kTile / 4));
    float v[2][4], w[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[p][q] = s.plane[p][b + q][a];
        v[p][q] = diag ? s.plane[p][a][b + q] + w[p][q] : s.plane[p][a][b + q];
      }
    }
    store4(s3, n, i0 + a, j0 + b, v[0]);
    store4(s5, n, i0 + a, j0 + b, v[1]);
    if (!diag) {
      store4(s3, n, j0 + a, i0 + b, w[0]);
      store4(s5, n, j0 + a, i0 + b, w[1]);
    }
  }
}

__global__ void __launch_bounds__(kTriThreads)
direct_efp_tri_kernel(const float* __restrict__ sites, const float* __restrict__ mu, int n,
                      int nt, Consts c, float* __restrict__ part) {
  __shared__ __align__(16) SmemK2 s;
  int ti, tj;
  tile_pair(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  load_tiles(sites, mu, n, i0, j0, s);
  const Derived k = derive(c);

  run_pairs(s, i0, j0, n, diag, c, k, [&](int r, int cc) {
    const Site si = smem_site(s.row[r]), sj = smem_site(s.col[cc]);
    Pair p;
    float a[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float pot_j = 0.0f;
    if (pair_chain<true, true>(si, sj, i0 + r, j0 + cc, c, k, p)) {
      efp_pair(p, si.q, sj.q, s.mrow[r], s.mcol[cc], a);
      pot_j = efp_pot_col(p, si.q, s.mrow[r]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) s.plane[q][r][cc] = a[q];
    s.plane[4][r][cc] = pot_j;
    s.plane[5][r][cc] = 2.0f * a[4];        // efp_pair adds half the pair energy
  });

  // row i: force, pot_i, e_pair; column j: -force, pot_j
  sum_tile<kOutK2, true>(
      s, ti, tj, n, diag, part,
      [&](bool on, bool is_row, int r, int cc, float (&f)[kOutK2]) {
        float v[5];
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = s.plane[a][r][cc];
        v[3] = s.plane[is_row ? 3 : 4][r][cc];
        v[4] = s.plane[5][r][cc];
        if (on) {
#pragma unroll
          for (int a = 0; a < 4; ++a) f[a] += v[a];
          if (is_row) f[4] += v[4];
        }
      },
      [](bool is_row, float (&f)[kOutK2]) {
        if (!is_row) {
#pragma unroll
          for (int a = 0; a < 3; ++a) f[a] = -f[a];
        }
      });
}

// out(q, s) = the sum over tiles of part[b, q, s], in a fixed order: warp
// g of the block adds the tiles b of group g, [g nt / kSumGroups, (g + 1)
// nt / kSumGroups), in order, lane l for site 32 blockIdx.x + l (sites
// first, then q); then lane l of warp 0 adds the groups in order. q < 3
// into vec[s, q], q = 3 into pot[s], q = 4 into e_row[s].
__global__ void __launch_bounds__(32 * kSumGroups)
tile_sum_kernel(const float* __restrict__ part, int nt, int n_out, int n,
                float* __restrict__ vec, float* __restrict__ pot, float* __restrict__ e_row) {
  __shared__ float grp[kSumGroups][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int blocks_q = (n + 31) / 32;
  const int q = blockIdx.x / blocks_q, site = (blockIdx.x % blocks_q) * 32 + lane;
  const size_t stride = (size_t)n_out * n;
  float acc = 0.0f;
  if (site < n) {
    const float* __restrict__ p = part + (size_t)q * n + site;
    const int b1 = (g + 1) * nt / kSumGroups;
#pragma unroll 8
    for (int b = g * nt / kSumGroups; b < b1; ++b) acc += p[b * stride];
  }
  grp[g][lane] = acc;
  __syncthreads();
  if (g == 0 && site < n) {
    float v = grp[0][lane];
#pragma unroll
    for (int a = 1; a < kSumGroups; ++a) v += grp[a][lane];
    if (q < 3) vec[(size_t)site * 3 + q] = v;
    else if (q == 3) pot[site] = v;
    else e_row[site] = v;
  }
}

__global__ void empty_kernel() {}

int n_tiles(int n) { return (n + kTile - 1) / kTile; }

cudaError_t launch_tile_sum(const float* part, int nt, int n_out, int n, float* vec, float* pot,
                            float* e_row, cudaStream_t st) {
  const int blocks = n_out * ((n + 31) / 32);
  tile_sum_kernel<<<blocks, 32 * kSumGroups, 0, st>>>(part, nt, n_out, n, vec, pot, e_row);
  return cudaGetLastError();
}

}  // namespace

// part: scratch of n_tiles x 3 x n floats, n_tiles = ceil(n / tile); the
// caller's tile must be kTile
extern "C" int mbpol_fixed_field_scf(const float* sites, int n, float alpha, float cutoff2,
                                     float g_cc, float g_cd, float g_dd, float g_ddoh,
                                     float g_ddhh, float bx, float by, float bz, int tile,
                                     float* part, float* field, float* s3, float* s5,
                                     void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = n_tiles(n);
  fixed_field_tri_kernel<<<nt * (nt + 1) / 2, kTriThreads, 0, st>>>(sites, n, nt, c, part, s3,
                                                                    s5);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_tile_sum(part, nt, kOutK1, n, field, nullptr, nullptr, st));
}

// part: scratch of n_tiles x 5 x n floats, as above
extern "C" int mbpol_direct_efp(const float* sites, const float* mu, int n, float alpha,
                                float cutoff2, float g_cc, float g_cd, float g_dd,
                                float g_ddoh, float g_ddhh, float bx, float by, float bz,
                                int tile, float* part, float* force, float* pot, float* e_row,
                                void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = n_tiles(n);
  direct_efp_tri_kernel<<<nt * (nt + 1) / 2, kTriThreads, 0, st>>>(sites, mu, n, nt, c, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_tile_sum(part, nt, kOutK2, n, force, pot, e_row, st));
}

// one launch of an empty kernel: the card's floor per launch, for the record
extern "C" int mbpol_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
