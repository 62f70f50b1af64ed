// Direct-space PME electrostatics pair kernels for Hopper (sm_90a), the
// dense path (models/potential.py keeps it up to DENSE_LIMIT_KERNELS waters).
//
// K1 `fixed_field_tri_kernel` replaces _fixed_field_kernel_tri of
// mbpol_openmm_plugin_tpu/ops/elec_pallas.py: the direct fixed charge field
// [N,3] and the full symmetric SCF factor matrices s3/s5 [N,N].
// K2 `direct_efp_tri_kernel` replaces _pair_force_kernel_tri: given the
// induced dipoles, the direct-space energy, the per-site pair force [N,3]
// and the per-site potential [N].
// `fixed_field_rows_kernel` and `direct_efp_rows_kernel` replace the
// full-grid _fixed_field_kernel and _pair_force_kernel, which the TPU
// package runs row-sharded over a device mesh: the same functions for a
// range of rows against every column (the sharded dense path; a triangular
// split would give the row shards unequal work). Their design is not the
// tile pairs' (below, before them): rows own blocks and walk their columns,
// one launch each.
// `tile_sum_kernel`, launched after K1 and K2, adds up their per-tile
// partials.
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
// The row kernels (#3, #4) take one shard's rows against all n columns. #3
// must store its s3/s5 rows, 2 x n_rows x n_cols x 4 B (134 MB a shard of
// 2048 rows at water2048), and both need the chains of those rows' ordered
// in-cutoff pairs, ~5% of the candidates at water2048. Design: rows own
// blocks and walk a contiguous range of column tiles, staged through shared
// memory by cp.async, queueing the pairs that pass the r^2 test so that the
// lanes run full passes of chains; the rows' sums stay in registers, and
// the column ranges' partials are added by the last block of each row
// block, in one launch (details before fixed_field_rows_kernel). #3's chains write a shared slab of the chunk's
// s3/s5 rows, which the block stores whole, zeros included, as rows of
// 16-byte stores.
//
// Packed site layout [N, 8] float32: x, y, z, q, damping^(-1/6), molecule
// id, is-oxygen flag, unused. Sites at or past n are bound-checked (no
// padding). The C entry points take device pointers, sizes, the physics
// constants, the partials scratch and the stream, allocate nothing and
// return cudaGetLastError().

#include <algorithm>

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
// (loosened r^2; in a diagonal tile r < c; sites past n rejected) and sets rmask for its rows and
// cpart[w] for every column. The block then lists the survivors row-major,
// and warp w runs run(r, c) on the list's chunks of 32 pairs w, w +
// kTriWarps, ... Ends with a __syncthreads.
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

// The full-grid row kernels (#3/#4 of the TPU package, the sharded dense
// path): the rows [row0, row0 + n_rows) against every column, each ordered
// pair's chain once (self pairs excluded), row sums only. Rows own blocks
// and columns are walked: block (rb, g) owns the kRowsBlock rows rb and the
// g-th of G contiguous ranges of column tiles (row_groups: G from the
// shapes alone, so that the blocks fill the card), warp w the rows
// w * kRowsWarp .. + kRowsWarp - 1 of the block.
// The block stages its column range in chunks of kTiles tiles through
// shared memory with cp.async, double-buffered (the next chunk's copies in
// flight while this one is walked). The dense sites are in water order, not
// sorted in space, so a tile's columns spread over the whole box and no
// tile is culled whole; the tests are made cheap instead. Coordinates are
// wrapped into the box (the rows once, a lane's column once per tile), so
// that a distance needs no rounding: per axis min(|d|, L - |d|). Level 1:
// lane l tests column l against the sphere that holds its warp's rows
// (centre the first real row, radius the farthest, padded as
// elec_direct_bs.cu's culling pads its boxes: a column outside it is
// outside the cutoff of every row) and queues the columns inside it. Level
// 2, per 32 queued columns: lane l tests its column against each of the
// warp's rows on r^2 (kLoose) and queues the surviving (row, column) pairs,
// rows then lanes, in the warp's ring. Whenever 32 pairs are queued each
// lane runs the exact test
// and chain of one, and at the chunk's end the rest, so the lanes run full
// passes although ~95% of the candidates fail at water2048. A lane adds its
// pairs into the sums of their rows in registers; after the walk each row's
// sums are added over the lanes by a butterfly of shuffles. With G = 1 the
// block writes its rows; else it writes its partials [G, K, n_rows], and the
// last of the row block's G blocks to finish (a ticket counter per row
// block, which that block sets back to 0) adds the partials in group order
// and writes the rows: one launch, no atomics on values, and an order fixed
// by the data alone, so every run gives the same bits. (Tried on the H100
// and not kept: a thread block cluster of the G blocks adding their sums
// through distributed shared memory, slower at water2048 and water4096,
// where a cluster's blocks hold their SMs until its slowest one is done;
// one or two rows a warp, slower at water256.)
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowsWarp = 4;                          // rows a warp owns
constexpr int kRowsBlock = kRowWarps * kRowsWarp;     // rows a block owns
constexpr int kMinBlocksRows = 3;                     // resident blocks the registers allow
constexpr int kTilesEfp = 8;                          // column tiles staged at once: #4
constexpr int kTilesField = 4;                        // #3 (its s3/s5 slab)
constexpr int kCand = 64;                             // per-warp ring of level-1 columns
constexpr int kRing = 256;                            // per-warp ring of queued pairs
constexpr int kEntryRow = 8;                          // ring entry: row << kEntryRow | column
// blocks a launch aims for: two to three waves of the H100's 132 SMs at
// kMinBlocksRows blocks each (a constant, so that G, and the order of the
// sums, depend on the shapes alone)
constexpr int kTargetBlocks = 8 * 132;
// the level-1 sphere's padding (nm, and per nm of the box: ~16 float32 ulps)
constexpr float kSpherePad = 1e-4f;
constexpr float kSphereRel = 2e-6f;

static_assert(kCand >= 2 * 32 && (kCand & (kCand - 1)) == 0,
              "the level-1 ring holds < 32 columns plus one tile's 32");
static_assert(kRing >= 31 + 32 * kRowsWarp && (kRing & (kRing - 1)) == 0,
              "the ring holds < 32 pairs plus one level-2 pass's 32 x kRowsWarp");
static_assert(kTilesEfp * kTile <= (1 << kEntryRow) && kTilesField <= kTilesEfp
              && kRowsWarp <= (1 << (16 - kEntryRow)),
              "a chunk column fits a byte, a ring entry 16 bits");
static_assert(3 * kTilesEfp * kTile / 4 <= kRowThreads, "one dipole copy per thread and chunk");

// The column groups of a launch on n_rows rows and n_cols columns: G ranges
// of the column tiles, so that the row blocks x G blocks fill the card.
int row_groups(int n_rows, int n_cols) {
  const int nrb = (n_rows + kRowsBlock - 1) / kRowsBlock;
  const int nct = (n_cols + kTile - 1) / kTile;
  return std::max(1, std::min(nct, kTargetBlocks / nrb));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x wrapped into [0, L] (up to rounding: within a few ulps of L outside it)
__device__ __forceinline__ float wrap(float x, float L, float inv_l) {
  return x - floorf(x * inv_l) * L;
}
// the minimum-image length of d = a - b on an axis of length L, for a and
// b wrapped into the box
__device__ __forceinline__ float torus(float d, float L) { return fminf(fabsf(d), L - fabsf(d)); }

// Shared memory of a row block: the staged column sites (two float4 each)
// of two chunks of kTiles tiles, the block's row sites and their wrapped
// positions (NaN for rows past n_rows or n), each warp's rings and the
// ticket; #4 adds the dipoles, #3 the chunk's s3/s5 slab.
template <int kTiles>
struct RowSmem {
  static constexpr int kCols = kTiles * kTile;
  float4 col[2][kCols][2];
  float4 wrow[kRowsBlock];
  float row[kRowsBlock][kNS];
  unsigned char cand[kRowWarps][kCand];
  unsigned short ring[kRowWarps][kRing];
  unsigned ticket;
};
struct EfpRowSmem : RowSmem<kTilesEfp> {
  static constexpr bool kEfp = true;
  float mu[2][3 * kCols];
  float mrow[kRowsBlock][3];
};
struct FieldRowSmem : RowSmem<kTilesField> {
  static constexpr bool kEfp = false;
  float s3[kRowsBlock][kCols];
  float s5[kRowsBlock][kCols];
};

__device__ __forceinline__ Site row_site(const float (&s)[kNS]) {
  return Site{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
}

// Issue the copies of the nc columns from c0 (sites at or past n zero) into
// buffer `buf`, and of their dipoles for #4; one commit group.
template <class Smem>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ sites,
                                            const float* __restrict__ mu, int n, int c0, int nc,
                                            int buf, Smem& S) {
  for (int t = threadIdx.x; t < 2 * nc; t += kRowThreads) {
    const int j = c0 + t / 2;
    cp_async16(&S.col[buf][t / 2][t % 2], j < n ? sites + 8 * (size_t)j + 4 * (t % 2) : sites,
               j < n ? 16 : 0);
  }
  if constexpr (Smem::kEfp) {
    const int t = threadIdx.x;
    if (t < 3 * nc / 4) {
      const int f = 3 * c0 + 4 * t;
      const int bytes = max(0, min(16, 4 * (3 * n - f)));
      cp_async16(&S.mu[buf][4 * t], bytes > 0 ? mu + f : mu, bytes);
    }
  }
  cp_async_commit();
}

// Walk the block's column tiles [t0, t1): per chunk, the tests, the queue
// and the pairs (run(entry, buf, c0)), then chunk_done(buf, c0, nc) with
// the chunk's pairs all run (ends with __syncthreads).
template <class Smem, class Run, class Done>
__device__ __forceinline__ void walk_columns(const float* __restrict__ sites,
                                             const float* __restrict__ mu, int n, int t0, int t1,
                                             const Consts& c, const Derived& k, Smem& S, Run run,
                                             Done chunk_done) {
  constexpr int kTiles = Smem::kCols / kTile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float loose2 = kLoose * c.cutoff2;
  // the sphere of the warp's rows: centre the first real row, radius the
  // farthest real row (no real row: nothing passes)
  float4 ctr = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float radius = -1.0f;
#pragma unroll
  for (int b = 0; b < kRowsWarp; ++b) {
    const float4 p = S.wrow[w * kRowsWarp + b];
    if (p.x == p.x) {
      if (radius < 0.0f) {
        ctr = p;
        radius = 0.0f;
      }
      const float dx = torus(p.x - ctr.x, c.bx), dy = torus(p.y - ctr.y, c.by),
                  dz = torus(p.z - ctr.z, c.bz);
      radius = fmaxf(radius, sqrtf(dx * dx + dy * dy + dz * dz));
    }
  }
  const float reach = sqrtf(loose2) + radius + kSpherePad
                      + kSphereRel * fmaxf(c.bx, fmaxf(c.by, c.bz));
  const float reach2 = radius < 0.0f ? -1.0f : reach * reach;

  unsigned char* __restrict__ cand = S.cand[w];
  unsigned short* __restrict__ ring = S.ring[w];
  unsigned ch = 0, ct = 0, head = 0, tail = 0;       // warp-uniform ring counters

  // level 2: column jl (when on) against each of the warp's rows; queue the
  // pairs that pass (rows, then lanes) and run the full passes
  auto level2 = [&](int jl, bool on, int buf, int c0) {
    const float4 p = S.col[buf][jl][0];
    const float x = wrap(p.x, c.bx, k.ibx), y = wrap(p.y, c.by, k.iby),
                z = wrap(p.z, c.bz, k.ibz);
#pragma unroll
    for (int b = 0; b < kRowsWarp; ++b) {
      const float4 r = S.wrow[w * kRowsWarp + b];
      const float dx = torus(x - r.x, c.bx), dy = torus(y - r.y, c.by), dz = torus(z - r.z, c.bz);
      const bool keep = on && dx * dx + dy * dy + dz * dz <= loose2;
      const unsigned bits = __ballot_sync(kFull, keep);
      if (keep) ring[(tail + __popc(bits & below)) & (kRing - 1)] =
          (unsigned short)((b << kEntryRow) | jl);
      tail += __popc(bits);
    }
  };
  auto run_full = [&](int buf, int c0) {
    __syncwarp();
    for (; tail - head >= 32; head += 32) run(ring[(head + lane) & (kRing - 1)], buf, c0);
    __syncwarp();
  };

  const int n_chunks = (t1 - t0 + kTiles - 1) / kTiles;
  for (int q = 0; q < n_chunks; ++q) {
    const int buf = q & 1;
    const int tile0 = t0 + q * kTiles;
    const int c0 = tile0 * kTile, nc = min(kTiles, t1 - tile0) * kTile;
    if (q + 1 < n_chunks) {
      const int next = tile0 + kTiles;
      stage_chunk(sites, mu, n, next * kTile, min(kTiles, t1 - next) * kTile, buf ^ 1, S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int jl = lane; jl < nc; jl += kTile) {
      // level 1: the column against the warp's sphere
      const float4 p = S.col[buf][jl][0];
      const float dx = torus(wrap(p.x, c.bx, k.ibx) - ctr.x, c.bx);
      const float dy = torus(wrap(p.y, c.by, k.iby) - ctr.y, c.by);
      const float dz = torus(wrap(p.z, c.bz, k.ibz) - ctr.z, c.bz);
      const bool near = c0 + jl < n && dx * dx + dy * dy + dz * dz <= reach2;
      const unsigned bits = __ballot_sync(kFull, near);
      if (near) cand[(ct + __popc(bits & below)) & (kCand - 1)] = (unsigned char)jl;
      ct += __popc(bits);
      __syncwarp();
      for (; ct - ch >= 32; ch += 32) {
        level2(cand[(ch + lane) & (kCand - 1)], true, buf, c0);
        run_full(buf, c0);
      }
    }
    if (ct != ch) {
      const bool on = ch + lane < ct;
      level2(on ? cand[(ch + lane) & (kCand - 1)] : 0, on, buf, c0);
      ch = ct;
      run_full(buf, c0);
    }
    if (head + lane < tail) run(ring[(head + lane) & (kRing - 1)], buf, c0);
    head = tail;
    __syncwarp();
    chunk_done(buf, c0, nc);
  }
}

// Add acc[b][q] (row w * kRowsWarp + b, output q) over the warp's lanes and
// write each row's sums through write(row, q, v) (rows at or past n_rows
// skipped): at once when G = 1, else through the partials part[G, kOut,
// n_rows] and the last block of the row block rb, which adds them in group
// order and sets its ticket counter back to 0. The block's barrier and its
// first thread's fence before the ticket make the block's partials visible
// to the last block (the pattern of the cooperative groups' grid barrier).
template <int kOut, class Smem, class Write>
__device__ __forceinline__ void finish_rows(float (&acc)[kRowsWarp][kOut], int rb, int g, int G,
                                            int n_rows, float* __restrict__ part,
                                            unsigned* __restrict__ tickets, Smem& S,
                                            Write write) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int local0 = rb * kRowsBlock;
  float mine = 0.0f;
#pragma unroll
  for (int b = 0; b < kRowsWarp; ++b) {
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      float v = acc[b][q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == b * kOut + q) mine = v;
    }
  }
  const int row = local0 + w * kRowsWarp + lane / kOut;
  const bool writes = lane < kRowsWarp * kOut && row < n_rows;
  if (G == 1) {
    if (writes) write(row, lane % kOut, 0.0f + mine);
    return;
  }
  if (writes) part[((size_t)g * kOut + lane % kOut) * n_rows + row] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    S.ticket = atomicAdd(&tickets[rb], 1u);
    if (S.ticket == (unsigned)(G - 1)) __threadfence();
  }
  __syncthreads();
  if (S.ticket != (unsigned)(G - 1)) return;
  const size_t stride = (size_t)kOut * n_rows;
  for (int e = threadIdx.x; e < kRowsBlock * kOut; e += kRowThreads) {
    const int r = local0 + e / kOut, q = e % kOut;
    if (r >= n_rows) continue;
    const float* __restrict__ p = part + (size_t)q * n_rows + r;
    // the group partials in order, their loads issued kBatch at a time
    constexpr int kBatch = 8;
    float v = 0.0f;
    int gg = 0;
    for (; gg + kBatch <= G; gg += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) x[u] = __ldcg(p + (gg + u) * stride);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v += x[u];
    }
    for (; gg < G; ++gg) v += __ldcg(p + gg * stride);
    write(r, q, v);
  }
  if (threadIdx.x == 0) tickets[rb] = 0u;
}

// Load the block's row sites (rows at or past n zero), their wrapped
// positions and, for #4, their dipoles; stage the first chunk; ends with
// __syncthreads.
template <class Smem>
__device__ __forceinline__ void begin_rows(const float* __restrict__ sites,
                                           const float* __restrict__ mu, int n, int i0,
                                           int local0, int n_rows, int t0, int t1,
                                           const Consts& c, const Derived& k, Smem& S) {
  constexpr int kTiles = Smem::kCols / kTile;
  const int t = threadIdx.x;
  if (t0 < t1) stage_chunk(sites, mu, n, t0 * kTile, min(kTiles, t1 - t0) * kTile, 0, S);
  if (t < kRowsBlock * kNS)
    S.row[t / kNS][t % kNS] = i0 + t / kNS < n ? sites[(size_t)i0 * kNS + t] : 0.0f;
  if (t < kRowsBlock) {
    float4 p = make_float4(NAN, NAN, NAN, 0.0f);
    if (local0 + t < n_rows && i0 + t < n) {
      const float* s = sites + (size_t)(i0 + t) * kNS;
      p = make_float4(wrap(s[0], c.bx, k.ibx), wrap(s[1], c.by, k.iby), wrap(s[2], c.bz, k.ibz),
                      0.0f);
    }
    S.wrow[t] = p;
  }
  if constexpr (Smem::kEfp) {
    if (t < kRowsBlock * 3)
      S.mrow[t / 3][t % 3] = i0 + t / 3 < n ? mu[(size_t)i0 * 3 + t] : 0.0f;
  }
  __syncthreads();
}

// The block's row block rb = blockIdx / G, column group g = blockIdx % G,
// first row (local to the launch) and column tiles [t0, t1).
struct RowBlock {
  int rb, g, local0, t0, t1;
};
__device__ __forceinline__ RowBlock row_block(int G, int nct) {
  const int rb = blockIdx.x / G, g = blockIdx.x % G;
  return RowBlock{rb, g, rb * kRowsBlock, (int)((long long)g * nct / G),
                  (int)((long long)(g + 1) * nct / G)};
}

// #3: K1 over the full grid for rows [row0, row0 + n_rows): the field rows
// and s3/s5 rows [n_rows, n_cols], every entry written once (zeros outside
// the cutoff, on the diagonal and for rows or columns at or past n). The
// chains write their s3/s5 into the chunk's shared slab (zeros elsewhere),
// which the block then stores as rows of 16-byte streaming stores, zeros
// included, and clears.
__global__ void __launch_bounds__(kRowThreads, kMinBlocksRows)
fixed_field_rows_kernel(const float* __restrict__ sites, int n, int row0, int n_rows,
                        int n_cols, int G, Consts c, float* __restrict__ part,
                        unsigned* __restrict__ tickets, float* __restrict__ field,
                        float* __restrict__ s3, float* __restrict__ s5) {
  constexpr int kCols = FieldRowSmem::kCols;
  __shared__ __align__(16) FieldRowSmem S;
  const RowBlock B = row_block(G, (n_cols + kTile - 1) / kTile);
  const int i0 = row0 + B.local0, w = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < kRowsBlock * kCols / 4; e += kRowThreads) {
    reinterpret_cast<float4*>(&S.s3[0][0])[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(&S.s5[0][0])[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const Derived k = derive(c);
  begin_rows(sites, nullptr, n, i0, B.local0, n_rows, B.t0, B.t1, c, k, S);
  float acc[kRowsWarp][kOutK1];
#pragma unroll
  for (int b = 0; b < kRowsWarp; ++b) acc[b][0] = acc[b][1] = acc[b][2] = 0.0f;
  const bool vec = (n_cols & 3) == 0;

  walk_columns(
      sites, nullptr, n, B.t0, B.t1, c, k, S,
      [&](unsigned e, int buf, int c0) {
        const int b = e >> kEntryRow, jl = e & ((1 << kEntryRow) - 1);
        const int r = w * kRowsWarp + b;
        const float4 p0 = S.col[buf][jl][0], p1 = S.col[buf][jl][1];
        const Site sj{p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z};
        Pair p;
        if (pair_chain<false, true>(row_site(S.row[r]), sj, i0 + r, c0 + jl, c, k, p)) {
          float v3, v5;
          scf_factors(p, v3, v5);
          const float kq = fixed_field_kq(p, sj.q);
#pragma unroll
          for (int bb = 0; bb < kRowsWarp; ++bb)
            if (bb == b) {
              acc[bb][0] += kq * p.dx;
              acc[bb][1] += kq * p.dy;
              acc[bb][2] += kq * p.dz;
            }
          S.s3[r][jl] = v3;
          S.s5[r][jl] = v5;
        }
      },
      [&](int, int c0, int nc) {
        __syncthreads();
        const int c_end = min(nc, n_cols - c0);
        for (int e = threadIdx.x; e < kRowsBlock * kCols / 4; e += kRowThreads) {
          const int r = e / (kCols / 4), cc = 4 * (e % (kCols / 4));
          if (cc >= nc) continue;
          float4* a3 = reinterpret_cast<float4*>(&S.s3[r][cc]);
          float4* a5 = reinterpret_cast<float4*>(&S.s5[r][cc]);
          const float4 v3 = *a3, v5 = *a5;
          *a3 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          *a5 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const int row = B.local0 + r;
          if (row >= n_rows || cc >= c_end) continue;
          float* o3 = s3 + (size_t)row * n_cols + c0 + cc;
          float* o5 = s5 + (size_t)row * n_cols + c0 + cc;
          if (vec && cc + 3 < c_end) {
            __stcs(reinterpret_cast<float4*>(o3), v3);
            __stcs(reinterpret_cast<float4*>(o5), v5);
          } else {
            const float x3[4] = {v3.x, v3.y, v3.z, v3.w}, x5[4] = {v5.x, v5.y, v5.z, v5.w};
            for (int qq = 0; qq < 4 && cc + qq < c_end; ++qq) {
              o3[qq] = x3[qq];
              o5[qq] = x5[qq];
            }
          }
        }
        __syncthreads();
      });

  // field_i = -sum_j q_j kdir d
  finish_rows<kOutK1>(acc, B.rb, B.g, G, n_rows, part, tickets, S,
                      [&](int row, int q, float v) { field[(size_t)row * 3 + q] = -v; });
}

// #4: K2 over the full grid for rows [row0, row0 + n_rows): per row the
// force, the potential and half the pair-energy sum (the TPU kernel's
// output columns 0..4).
__global__ void __launch_bounds__(kRowThreads, kMinBlocksRows)
direct_efp_rows_kernel(const float* __restrict__ sites, const float* __restrict__ mu, int n,
                       int row0, int n_rows, int G, Consts c, float* __restrict__ part,
                       unsigned* __restrict__ tickets, float* __restrict__ force,
                       float* __restrict__ pot, float* __restrict__ e_row) {
  __shared__ __align__(16) EfpRowSmem S;
  const RowBlock B = row_block(G, (n + kTile - 1) / kTile);
  const int i0 = row0 + B.local0, w = threadIdx.x >> 5;
  const Derived k = derive(c);
  begin_rows(sites, mu, n, i0, B.local0, n_rows, B.t0, B.t1, c, k, S);
  float acc[kRowsWarp][kOutK2];
#pragma unroll
  for (int b = 0; b < kRowsWarp; ++b) {
#pragma unroll
    for (int q = 0; q < kOutK2; ++q) acc[b][q] = 0.0f;
  }

  walk_columns(
      sites, mu, n, B.t0, B.t1, c, k, S,
      [&](unsigned e, int buf, int c0) {
        const int b = e >> kEntryRow, jl = e & ((1 << kEntryRow) - 1);
        const int r = w * kRowsWarp + b;
        const float4 p0 = S.col[buf][jl][0], p1 = S.col[buf][jl][1];
        const Site si = row_site(S.row[r]), sj{p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z};
        float a[kOutK2] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        Pair p;
        if (pair_chain<true, true>(si, sj, i0 + r, c0 + jl, c, k, p))
          efp_pair(p, si.q, sj.q, S.mrow[r], &S.mu[buf][3 * jl], a);
#pragma unroll
        for (int bb = 0; bb < kRowsWarp; ++bb)
          if (bb == b) {
#pragma unroll
            for (int q = 0; q < kOutK2; ++q) acc[bb][q] += a[q];
          }
      },
      [](int, int, int) { __syncthreads(); });

  finish_rows<kOutK2>(acc, B.rb, B.g, G, n_rows, part, tickets, S,
                      [&](int row, int q, float v) {
                        if (q < 3) force[(size_t)row * 3 + q] = v;
                        else if (q == 3) pot[row] = v;
                        else e_row[row] = v;
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

// The column groups G of the row kernels' launch on n_rows rows and n_cols
// columns (their partials scratch holds G x K x n_rows floats when G > 1).
extern "C" int mbpol_rows_groups(int n_rows, int n_cols) { return row_groups(n_rows, n_cols); }

// Rows [row0, row0 + n_rows) of K1 over the full grid; s3, s5: [n_rows,
// n_cols] (n_cols >= n; columns at or past n are written as zeros); part:
// scratch of G x 3 x n_rows floats (G = mbpol_rows_groups(n_rows, n_cols);
// none when G = 1); tickets: n_rows counters, zero, which the launch
// leaves zero; the caller's tile must be kTile
extern "C" int mbpol_fixed_field_scf_rows(const float* sites, int n, int row0, int n_rows,
                                          int n_cols, float alpha, float cutoff2, float g_cc,
                                          float g_cd, float g_dd, float g_ddoh, float g_ddhh,
                                          float bx, float by, float bz, int tile, float* part,
                                          unsigned* tickets, float* field, float* s3, float* s5,
                                          void* stream) {
  if (tile != kTile || n_cols < n) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const int G = row_groups(n_rows, n_cols), nrb = (n_rows + kRowsBlock - 1) / kRowsBlock;
  fixed_field_rows_kernel<<<nrb * G, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, n, row0, n_rows, n_cols, G, c, part, tickets, field, s3, s5);
  return static_cast<int>(cudaGetLastError());
}

// Rows [row0, row0 + n_rows) of K2 over the full grid; part: scratch of G x
// 5 x n_rows floats (G = mbpol_rows_groups(n_rows, n)); tickets as above
extern "C" int mbpol_direct_efp_rows(const float* sites, const float* mu, int n, int row0,
                                     int n_rows, float alpha, float cutoff2, float g_cc,
                                     float g_cd, float g_dd, float g_ddoh, float g_ddhh,
                                     float bx, float by, float bz, int tile, float* part,
                                     unsigned* tickets, float* force, float* pot, float* e_row,
                                     void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const int G = row_groups(n_rows, n), nrb = (n_rows + kRowsBlock - 1) / kRowsBlock;
  direct_efp_rows_kernel<<<nrb * G, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, mu, n, row0, n_rows, G, c, part, tickets, force, pot, e_row);
  return static_cast<int>(cudaGetLastError());
}

// one launch of an empty kernel: the card's floor per launch, for the record
extern "C" int mbpol_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
