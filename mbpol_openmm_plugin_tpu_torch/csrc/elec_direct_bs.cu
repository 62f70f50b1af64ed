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
// [np, 3] and the SCF factors s3/s5. The TPU kernel writes them as whole
// [256 x 256] blocks of the list; here they are LIVE LINES (below): the
// blocks' entries outside the lines are exact zeros that no reader needs.
// K3-bs `scf_field_bs_kernel` replaces _scf_field_bs_kernel: one SCF dipole
// field evaluation, field_i = sum_j s3_ij mu_j + s5_ij (mu_j . d_ij) d_ij
// over the live lines, recomputing only the minimum-image d_ij.
// K2-bs `direct_efp_bs_kernel` replaces _pair_force_bs_kernel: per-row
// force [np, 3], potential [np] and half pair-energy sums [np] given the
// induced dipoles.
// All three run the pair chain of elec_common.cuh, as the dense kernels do.
//
// Lines. A line is one (row water, 32-site column cluster w) pair of an
// entry: the water's kRows = 4 sorted rows x the cluster's 32 columns, 4 x
// 32 floats of s3 and the same of s5, four 128-byte rows. It is live when
// the culling test below keeps it. Each (row water, cluster) has a slab of
// n_lines slots: s3/s5 [np / 4, 8, n_lines, 4, 32], line_entry [np / 4, 8,
// n_lines] (the list entry of each line), line_count [np / 4, 8]; a slab
// holds its lines in list-entry order. K1-bs writes only live lines, counts
// every one and writes none past n_lines (count > n_lines is an overflow
// the wrapper reports); K3-bs walks line_entry[water, w, 0 : count].
//
// What bounds them on the H100 (water4096: 16,384 sites, 64 row tiles,
// 3682 active blocks; the 256-site tiles are ~1.24 nm cells, and only
// ~2.9% of the pairs of the active blocks lie inside the 0.9 nm cutoff):
// as the function goes, each needs only the in-cutoff pairs: K1-bs their
// chains (sqrtf, 1/r, erfcf, 3 expf) and their s3/s5 (~0.06 GB), K3-bs
// those bytes again, K2-bs the chains of the same pairs (erfcf, 4 expf,
// the H2 polynomial), ~0.02 ms each. The live lines hold 16.85% of the
// candidates and 0.325 GB of s3/s5 (the whole blocks: 1.93 GB).
//
// Design: rows, not tile pairs, own blocks. One CUDA block of 256 threads
// owns consecutive rows of one row tile (kRows = 4, one water; K2-bs:
// kRowsEfp) and loops over that row tile's run of the list;
// for each entry, warp w takes the 32-site cluster w of the column tile.
// Row sums stay in registers and are reduced inside the block in a fixed
// order: no atomics and no cross-block accumulation, so results are the
// same bits on every run. Line offsets are size_t.
//
// Culling (K1-bs, K2-bs). A pre-pass (`cluster_boxes_kernel`, one warp per
// cluster) writes a box per 32-site cluster of the sorted sites: the
// minimum images of the cluster's real sites relative to its first site,
// min/max by warp shuffles, so a cluster across the periodic boundary, or
// sites in unwrapped coordinates, give a box that holds an image of every
// site. Each block builds the box of each of its row waters the same way.
// Per chunk of kChunk list entries, the block copies tj into shared memory
// and tests every (entry, cluster) against its waters at once: a line is
// dead when the minimum-image gap between the boxes exceeds the cutoff,
// with each half extent padded by kCullMargin + kCullRel |coordinate|, so
// the test never drops a pair that the exact per-pair test keeps (on an
// axis the per-axis minimum image of any pair is at least |dc| - the two
// half extents when |dc| <= half a box). A warp walks only its live
// entries of the chunk (a ballot over the staged lines, one lane per
// entry).
// K1-bs: for each live line each lane runs its column's 4 row chains and
// writes v3/v5 as the line's 128-byte rows into the next slot of its slab.
// A thread adds its pairs to the field in entry order, as the unculled
// kernel did, and a dead line holds no pair that passes the chain's cutoff
// test, so the field and every s3/s5 value are the unculled kernel's bits.
// Its chains run one (row, lane) pair each, ~17% of them inside the
// cutoff; registers held to kMinBlocksK1 blocks per SM (80 -> 64, a few
// bytes spilled) read 0.329 ms against 0.360 at water4096.
// K3-bs runs no test: warp w walks its slab's lines (the column tiles of
// 32 lines loaded at once, one lane each, and shuffled out), with K1-bs's
// thread-to-column mapping and entry order, so its sums are the bits of
// the unculled kernel too. Its line loads are 128-byte coalesced rows. It
// is bound by the latency of those loads, not by their bytes, so the
// registers are held to kMinBlocksScf resident blocks per SM, and the
// loads of the next line are issued before the sums of this one: 0.193 ms
// at water4096, against 0.283 with each line's loads just before its own
// sums (measured slower: two lines' loads before their sums, with spills;
// 3, 6 or 8 blocks per SM; in the block layout, 16-byte loads, a lane
// owning four columns of one row, which also sum in another order).
// K2-bs rejects candidates of live lines on r^2 against a slightly loosened
// cutoff^2 (kLoose; no division, no sqrtf) and queues the survivors
// (row, column) in a per-warp ring in shared memory, in a fixed order
// (entries, then lanes, then rows). Whenever 32 are queued, each lane runs
// the exact test and, inside the cutoff, the chain of one of them, so a
// warp's 32 lanes run 32 useful chains instead of one chain per (row,
// lane) of every live line. A lane adds its pair into the accumulators of
// the pair's row: the sums are in another order than the unculled kernel's
// (held by the twin rows of ops/elec_direct_check.py), fixed by the data
// alone, so every run gives the same bits. The pair-independent constants
// (f1, f2, f3, g_cc^(1/4), 1/box) are computed once per thread (Derived).
// The chains are latency-bound: kRowsEfp = 4 rows a block (64 registers,
// four blocks per SM) beat 8 and 16 rows, whose accumulators cost
// resident warps.
//
// The C entry points take device pointers, sizes, the physics constants
// and the stream, allocate nothing (the wrapper passes the outputs and the
// box scratch) and return cudaGetLastError().

#include "elec_common.cuh"

namespace {

using namespace mbpol;

constexpr int kTile = 256;
constexpr int kRows = 4;                 // K1-bs, K3-bs: one water per block
constexpr int kSub = kTile / kRows;      // blocks per row tile
constexpr int kValid = 1;                // meta bit flags (elec_pallas_bs)
constexpr int kWater = 4;                // sites per water, consecutive in the sort
constexpr int kCluster = 32;             // column sites per warp and list entry
constexpr int kClusters = kTile / kCluster;
constexpr int kLine = kRows * kCluster;  // floats of s3 (and of s5) per line
constexpr int kChunk = kThreads / kClusters;   // list entries staged at once
// the blocks per SM the registers of K1-bs and K3-bs must allow
// (latency-bound: more warps; K3-bs read slower at 3, 6 and 8)
constexpr int kMinBlocksK1 = 4;
constexpr int kMinBlocksScf = 4;
// K2-bs: rows per block, and the per-warp ring of queued (row, column) pairs
constexpr int kRowsEfp = 4;
constexpr int kWatersEfp = kRowsEfp / kWater;
constexpr int kSubEfp = kTile / kRowsEfp;
constexpr int kQueue = 64 * kRowsEfp;     // a power of two, >= 2 x 32 + 32 x kRowsEfp
constexpr int kColBits = 24;             // queue entry: row << kColBits | column
// the culling test's padding of each half extent (nm, and per nm of the
// coordinate: ~16 float32 ulps)
constexpr float kCullMargin = 1e-4f;
constexpr float kCullRel = 2e-6f;
constexpr float kEmpty = -1e30f;         // half extent of a box without sites

static_assert(kThreads == kTile, "one thread per column of a column tile");
static_assert(kClusters == kWarps, "one warp per cluster of a column tile");
static_assert(kChunk == 32, "one lane per staged entry in a warp's ballot");
static_assert(kRows == kWater, "a block's rows are one water: a line's rows");
static_assert(kQueue >= 2 * 32 + 32 * kRowsEfp && (kQueue & (kQueue - 1)) == 0,
              "the ring holds < 32 pairs plus one entry's 32 x kRowsEfp");

// Block b of a launch over the row tiles row_tile0 .. row_tile0 +
// n_row_tiles - 1 (a shard's rows under a device mesh; 0 and all tiles on
// one device): its row tile in the launch (the index into the launch's
// list and row_start) and its first row, local to the launch (the index
// into its outputs) and global (the index into the sites).
__device__ __forceinline__ int row_tile() { return blockIdx.x / kSub; }
__device__ __forceinline__ int first_row() {
  return row_tile() * kTile + (blockIdx.x % kSub) * kRows;
}
__device__ __forceinline__ int first_site(int row_tile0) { return row_tile0 * kTile + first_row(); }

// An axis-aligned box that holds an image of each of a group's sites.
struct Box {
  float cx, cy, cz, hx, hy, hz;
};

__device__ __forceinline__ float box_pad(float ref) { return kCullMargin + kCullRel * fabsf(ref); }

// The box from the group's first site `ref` and the extremes lo/hi of its
// sites' minimum images relative to ref (lo > hi: no real site).
__device__ __forceinline__ Box make_box(const float* ref, const float* lo, const float* hi) {
  if (lo[0] > hi[0]) return Box{0.0f, 0.0f, 0.0f, kEmpty, kEmpty, kEmpty};
  return Box{ref[0] + 0.5f * (lo[0] + hi[0]), ref[1] + 0.5f * (lo[1] + hi[1]),
             ref[2] + 0.5f * (lo[2] + hi[2]), 0.5f * (hi[0] - lo[0]) + box_pad(ref[0]),
             0.5f * (hi[1] - lo[1]) + box_pad(ref[1]), 0.5f * (hi[2] - lo[2]) + box_pad(ref[2])};
}

// Box of the kWater row sites xyz[0..3] (rows at or past n are padding).
template <int kStride>
__device__ __forceinline__ Box water_box(const float* xyz, int i0, int n, const Consts& c) {
  const float b[3] = {c.bx, c.by, c.bz};
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int r = 0; r < kWater; ++r) {
    if (i0 + r >= n) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = min_image(xyz[r * kStride + a] - xyz[a], b[a]);
      lo[a] = fminf(lo[a], d);
      hi[a] = fmaxf(hi[a], d);
    }
  }
  return make_box(xyz, lo, hi);
}

__device__ __forceinline__ Box load_box(const float4* __restrict__ boxes, int g) {
  const float4 a = boxes[2 * g], h = boxes[2 * g + 1];
  return Box{a.x, a.y, a.z, h.x, h.y, h.z};
}

// True unless every pair of sites of the two boxes is farther apart than
// the cutoff (minimum image).
__device__ __forceinline__ bool boxes_meet(const Box& a, const Box& b, const Consts& c,
                                           const Derived& k) {
  const float gx = fmaxf(fabsf(min_image_fast(b.cx - a.cx, c.bx, k.ibx)) - (a.hx + b.hx), 0.0f);
  const float gy = fmaxf(fabsf(min_image_fast(b.cy - a.cy, c.by, k.iby)) - (a.hy + b.hy), 0.0f);
  const float gz = fmaxf(fabsf(min_image_fast(b.cz - a.cz, c.bz, k.ibz)) - (a.hz + b.hz), 0.0f);
  return gx * gx + gy * gy + gz * gz <= c.cutoff2;
}

// One warp per cluster of kCluster sorted sites: boxes[2g] = center,
// boxes[2g + 1] = half extents (kEmpty for a cluster of padded sites).
__global__ void __launch_bounds__(kThreads)
cluster_boxes_kernel(const float* __restrict__ sites, int n, int n_clusters, Consts c,
                     float4* __restrict__ boxes) {
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n_clusters) return;
  const float4* s4 = reinterpret_cast<const float4*>(sites);
  const int j = g * kCluster + lane;
  const float4 r4 = s4[2 * (size_t)g * kCluster];
  const float4 p = s4[2 * (size_t)j];
  const float ref[3] = {r4.x, r4.y, r4.z};
  const float d[3] = {min_image(p.x - r4.x, c.bx), min_image(p.y - r4.y, c.by),
                      min_image(p.z - r4.z, c.bz)};
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = j < n ? d[a] : INFINITY;
    hi[a] = j < n ? d[a] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if (lane == 0) {
    const Box bx = make_box(ref, lo, hi);
    boxes[2 * g] = make_float4(bx.cx, bx.cy, bx.cz, 0.0f);
    boxes[2 * g + 1] = make_float4(bx.hx, bx.hy, bx.hz, 0.0f);
  }
}

// Stage the list entries p0 .. p0 + kChunk - 1 of the row tile's run
// (ending at p_end): their column tiles into s_tj and, per (entry,
// cluster), the bit mask of the block's waters whose box meets the
// cluster's into s_live (0 for padded entries). Thread t tests entry
// t / kClusters against cluster t % kClusters. Ends with __syncthreads.
template <int kWaters>
__device__ __forceinline__ void stage_chunk(const int* __restrict__ tj,
                                            const int* __restrict__ meta,
                                            const float4* __restrict__ boxes, int p0, int p_end,
                                            const Box (&waters)[kWaters], const Consts& c,
                                            const Derived& k, int (&s_tj)[kChunk],
                                            unsigned char (&s_live)[kChunk][kClusters]) {
  const int e = threadIdx.x / kClusters, g = threadIdx.x % kClusters, p = p0 + e;
  unsigned live = 0;
  int col = 0;
  if (p < p_end && (meta[p] & kValid)) {
    col = tj[p];
    const Box cb = load_box(boxes, col * kClusters + g);
#pragma unroll
    for (int w = 0; w < kWaters; ++w) live |= (unsigned)boxes_meet(waters[w], cb, c, k) << w;
  }
  s_live[e][g] = (unsigned char)live;
  if (g == 0) s_tj[e] = col;
  __syncthreads();
}

// Block b = water b: its slab of cluster w starts at line (b * kClusters +
// w) * n_lines.
__device__ __forceinline__ size_t slab() {
  return (size_t)blockIdx.x * kClusters + (threadIdx.x >> 5);
}

__global__ void __launch_bounds__(kThreads, kMinBlocksK1)
fixed_field_bs_kernel(const float* __restrict__ sites, int n, int row_tile0,
                      const int* __restrict__ tj, const int* __restrict__ meta,
                      const int* __restrict__ row_start, Consts c,
                      const float4* __restrict__ boxes, int n_lines,
                      float* __restrict__ field, float* __restrict__ s3,
                      float* __restrict__ s5, int* __restrict__ line_entry,
                      int* __restrict__ line_count) {
  __shared__ float buf[kRows][kNS];
  __shared__ float red[kWarps][kRows * 3];
  __shared__ int s_tj[kChunk];
  __shared__ unsigned char s_live[kChunk][kClusters];
  const int i0 = first_site(row_tile0);
  const int t = threadIdx.x;
  const int w = t >> 5, lane = t & 31;
  Site rows[kRows];
  load_rows<kRows>(sites, n, i0, rows, buf);
  const Derived kd = derive(c);
  const Box water[1] = {water_box<kNS>(&buf[0][0], i0, n, c)};

  float acc[kRows * 3];
#pragma unroll
  for (int k = 0; k < kRows * 3; ++k) acc[k] = 0.0f;

  const size_t line0 = slab() * n_lines;
  int count = 0;                          // warp-uniform: the slab's lines so far
  const int p_begin = row_start[row_tile()], p_end = row_start[row_tile() + 1];
  for (int p0 = p_begin; p0 < p_end; p0 += kChunk) {
    stage_chunk<1>(tj, meta, boxes, p0, p_end, water, c, kd, s_tj, s_live);
    unsigned todo = __ballot_sync(0xffffffffu, s_live[lane][w]);
    while (todo) {
      const int e = __ffs(todo) - 1;
      todo &= todo - 1;
      const int j = s_tj[e] * kTile + t;
      const Site sj = load_site(sites, j);
      float v3[kRows], v5[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        Pair pr;
        v3[r] = 0.0f;
        v5[r] = 0.0f;
        if (i < n && j < n && pair_chain<false>(rows[r], sj, i, j, c, kd, pr)) {
          scf_factors(pr, v3[r], v5[r]);
          const float kq = fixed_field_kq(pr, sj.q);
          acc[3 * r + 0] += kq * pr.dx;
          acc[3 * r + 1] += kq * pr.dy;
          acc[3 * r + 2] += kq * pr.dz;
        }
      }
      if (count < n_lines) {
        const size_t l = line0 + count;
        float* __restrict__ o3 = s3 + l * kLine + lane;
        float* __restrict__ o5 = s5 + l * kLine + lane;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          o3[r * kCluster] = v3[r];
          o5[r * kCluster] = v5[r];
        }
        if (lane == 0) line_entry[l] = p0 + e;
      }
      ++count;
    }
    __syncthreads();                      // before the next chunk's staging
  }
  if (lane == 0) line_count[slab()] = count;
  block_sum<kRows * 3>(acc, red);
  if (t < kRows * 3) field[(size_t)first_row() * 3 + t] = -acc[0];
}

__global__ void __launch_bounds__(kThreads, kMinBlocksScf)
scf_field_bs_kernel(const float* __restrict__ sites, const float* __restrict__ mu,
                    int row_tile0, const int* __restrict__ tj, Consts c, int n_lines,
                    const float* __restrict__ s3, const float* __restrict__ s5,
                    const int* __restrict__ line_entry, const int* __restrict__ line_count,
                    float* __restrict__ field) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ float pbuf[kRows][3];
  __shared__ float red[kWarps][kRows * 3];
  const int i0 = first_site(row_tile0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t < kRows * 3) pbuf[t / 3][t % 3] = sites[(size_t)(i0 + t / 3) * kNS + t % 3];
  __syncthreads();

  float acc[kRows * 3];
#pragma unroll
  for (int q = 0; q < kRows * 3; ++q) acc[q] = 0.0f;

  const size_t line0 = slab() * n_lines;
  const int count = min(line_count[slab()], n_lines);
  const float* __restrict__ l3 = s3 + line0 * kLine + lane;
  const float* __restrict__ l5 = s5 + line0 * kLine + lane;
  for (int l0 = 0; l0 < count; l0 += 32) {
    // lane k: the column tile of line l0 + k
    const int col = l0 + lane < count ? tj[line_entry[line0 + l0 + lane]] : 0;
    const int m = min(32, count - l0);
    // the loads of line k + 1 are issued before the sums of line k, which
    // go in line order (the entry order of the unculled kernel)
    float4 pj;
    float mj[3], v3[kRows], v5[kRows];
    auto load = [&](int k) {
      const size_t j = (size_t)__shfl_sync(kFull, col, k) * kTile + t;
      const size_t l = (size_t)(l0 + k) * kLine;
      pj = reinterpret_cast<const float4*>(sites)[2 * j];
#pragma unroll
      for (int q = 0; q < 3; ++q) mj[q] = mu[3 * j + q];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        v3[r] = l3[l + r * kCluster];
        v5[r] = l5[l + r * kCluster];
      }
    };
    load(0);
    for (int k = 0; k < m; ++k) {
      const float4 cp = pj;
      const float cm[3] = {mj[0], mj[1], mj[2]};
      float c3[kRows], c5[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        c3[r] = v3[r];
        c5[r] = v5[r];
      }
      if (k + 1 < m) load(k + 1);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float d[3] = {min_image(cp.x - pbuf[r][0], c.bx),
                            min_image(cp.y - pbuf[r][1], c.by),
                            min_image(cp.z - pbuf[r][2], c.bz)};
        const float s5proj = c5[r] * (cm[0] * d[0] + cm[1] * d[1] + cm[2] * d[2]);
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[3 * r + q] += c3[r] * cm[q] + s5proj * d[q];
      }
    }
  }
  block_sum<kRows * 3>(acc, red);
  if (t < kRows * 3) field[(size_t)first_row() * 3 + t] = acc[0];
}

__global__ void __launch_bounds__(kThreads)
direct_efp_bs_kernel(const float* __restrict__ sites, const float* __restrict__ mu, int n,
                     int row_tile0, const int* __restrict__ tj, const int* __restrict__ meta,
                     const int* __restrict__ row_start, Consts c,
                     const float4* __restrict__ boxes, float* __restrict__ force,
                     float* __restrict__ pot, float* __restrict__ e_row) {
  constexpr int kOut = 5;   // fx, fy, fz, pot, energy
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ float buf[kRowsEfp][kNS];
  __shared__ float mbuf[kRowsEfp][3];
  __shared__ float red[kWarps][kRowsEfp * kOut];
  __shared__ int s_tj[kChunk];
  __shared__ unsigned char s_live[kChunk][kClusters];
  __shared__ unsigned s_queue[kWarps][kQueue];
  const int tile = blockIdx.x / kSubEfp;     // in the launch
  const int local0 = tile * kTile + (blockIdx.x % kSubEfp) * kRowsEfp;
  const int i0 = row_tile0 * kTile + local0;
  const int t = threadIdx.x;
  const int w = t >> 5, lane = t & 31;
  if (t < kRowsEfp * 3) mbuf[t / 3][t % 3] = mu[(size_t)i0 * 3 + t];
  if (t < kRowsEfp * kNS) {
    const int r = t / kNS;
    buf[r][t % kNS] = (i0 + r < n) ? sites[(size_t)(i0 + r) * kNS + t % kNS] : 0.0f;
  }
  __syncthreads();
  const Derived k = derive(c);
  Box waters[kWatersEfp];
#pragma unroll
  for (int g = 0; g < kWatersEfp; ++g)
    waters[g] = water_box<kNS>(&buf[g * kWater][0], i0 + g * kWater, n, c);

  float acc[kRowsEfp * kOut];
#pragma unroll
  for (int q = 0; q < kRowsEfp * kOut; ++q) acc[q] = 0.0f;
  unsigned* __restrict__ ring = s_queue[w];
  unsigned head = 0, tail = 0;            // warp-uniform ring counters
  const float loose2 = kLoose * c.cutoff2;

  // the exact test and chain of the queued pair `entry` into its row's sums
  auto run_pair = [&](unsigned entry) {
    const int r = entry >> kColBits;
    const int j = entry & ((1u << kColBits) - 1);
    const Site sj = load_site(sites, j);
    const float mj[3] = {mu[3 * (size_t)j], mu[3 * (size_t)j + 1], mu[3 * (size_t)j + 2]};
    const Site si{buf[r][0], buf[r][1], buf[r][2], buf[r][3], buf[r][4], buf[r][5], buf[r][6]};
    float a[kOut] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    Pair pr;
    if (pair_chain<true>(si, sj, i0 + r, j, c, k, pr)) efp_pair(pr, si.q, sj.q, mbuf[r], mj, a);
#pragma unroll
    for (int rr = 0; rr < kRowsEfp; ++rr)
      if (rr == r) {
#pragma unroll
        for (int q = 0; q < kOut; ++q) acc[kOut * rr + q] += a[q];
      }
  };

  const int p_begin = row_start[tile], p_end = row_start[tile + 1];
  for (int p0 = p_begin; p0 < p_end; p0 += kChunk) {
    stage_chunk<kWatersEfp>(tj, meta, boxes, p0, p_end, waters, c, k, s_tj, s_live);
    unsigned todo = __ballot_sync(kFull, s_live[lane][w]);
    while (todo) {
      const int e = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned live = s_live[e][w];
      const int j = s_tj[e] * kTile + w * kCluster + lane;
      // rows of the live waters whose pair passes the loosened r^2 test
      unsigned m = 0;
      if (j < n) {
        const float4 pj = reinterpret_cast<const float4*>(sites)[2 * (size_t)j];
#pragma unroll
        for (int r = 0; r < kRowsEfp; ++r) {
          if (!((live >> (r / kWater)) & 1u)) continue;
          const float dx = min_image_fast(pj.x - buf[r][0], c.bx, k.ibx);
          const float dy = min_image_fast(pj.y - buf[r][1], c.by, k.iby);
          const float dz = min_image_fast(pj.z - buf[r][2], c.bz, k.ibz);
          const bool keep = dx * dx + dy * dy + dz * dz <= loose2 && i0 + r < n && i0 + r != j;
          m |= (unsigned)keep << r;
        }
      }
      // enqueue in a fixed order: lanes in order, each lane's rows in order
      const int cnt = __popc(m);
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned slot = tail + (unsigned)(incl - cnt);
      while (m) {
        const int r = __ffs(m) - 1;
        m &= m - 1;
        ring[slot++ & (kQueue - 1)] = ((unsigned)r << kColBits) | (unsigned)j;
      }
      tail += (unsigned)__shfl_sync(kFull, incl, 31);
      __syncwarp();
      for (; tail - head >= 32; head += 32) run_pair(ring[(head + lane) & (kQueue - 1)]);
      __syncwarp();
    }
    __syncthreads();                      // before the next chunk's staging
  }
  if (head + lane < tail) run_pair(ring[(head + lane) & (kQueue - 1)]);

  block_sum<kRowsEfp * kOut>(acc, red);
  if (t < kRowsEfp * kOut) {
    const size_t i = (size_t)local0 + t / kOut;
    const int q = t % kOut;
    if (q < 3) force[i * 3 + q] = acc[0];
    else if (q == 3) pot[i] = acc[0];
    else e_row[i] = acc[0];
  }
}

cudaError_t launch_cluster_boxes(const float* sites, int n, int n_tiles, const Consts& c,
                                 float* boxes, cudaStream_t stream) {
  const int n_clusters = n_tiles * kClusters;
  cluster_boxes_kernel<<<(n_clusters + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      sites, n, n_clusters, c, reinterpret_cast<float4*>(boxes));
  return cudaGetLastError();
}

}  // namespace

// The entry points launch over the row tiles row_tile0 .. row_tile0 +
// n_row_tiles - 1 of the n_tiles tiles of the sites (0 and n_tiles on one
// device, a shard's slab under a mesh); the list (tj, meta, row_start) is
// that of those row tiles, and every output is indexed from row tile
// row_tile0 (rows, and line slabs).
// boxes: scratch of n_tiles x kClusters x 8 floats; s3, s5: [n_row_tiles x
// kSub, kClusters, n_lines, kRows, kCluster]; line_entry [n_row_tiles x
// kSub, kClusters, n_lines]; line_count [n_row_tiles x kSub, kClusters]
extern "C" int mbpol_fixed_field_scf_bs(const float* sites, int n, int n_tiles, int row_tile0,
                                        int n_row_tiles, const int* tj, const int* meta,
                                        const int* row_start, float alpha, float cutoff2,
                                        float g_cc, float g_cd, float g_dd, float g_ddoh,
                                        float g_ddhh, float bx, float by, float bz, int n_lines,
                                        float* boxes, float* field, float* s3, float* s5,
                                        int* line_entry, int* line_count, void* stream) {
  if (n_tiles <= 0 || n_row_tiles <= 0) return 0;
  if (row_tile0 < 0 || row_tile0 + n_row_tiles > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_cluster_boxes(sites, n, n_tiles, c, boxes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_field_bs_kernel<<<n_row_tiles * kSub, kThreads, 0, st>>>(
      sites, n, row_tile0, tj, meta, row_start, c, reinterpret_cast<const float4*>(boxes),
      n_lines, field, s3, s5, line_entry, line_count);
  return static_cast<int>(cudaGetLastError());
}

// the lines K1-bs wrote for these sites and row tiles (same n_lines)
extern "C" int mbpol_scf_field_bs(const float* sites, const float* mu, int n_tiles,
                                  int row_tile0, int n_row_tiles, const int* tj, float alpha,
                                  float cutoff2, float g_cc, float g_cd, float g_dd,
                                  float g_ddoh, float g_ddhh, float bx, float by, float bz,
                                  int n_lines, const float* s3, const float* s5,
                                  const int* line_entry, const int* line_count, float* field,
                                  void* stream) {
  if (n_tiles <= 0 || n_row_tiles <= 0) return 0;
  if (row_tile0 < 0 || row_tile0 + n_row_tiles > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  scf_field_bs_kernel<<<n_row_tiles * kSub, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sites, mu, row_tile0, tj, c, n_lines, s3, s5, line_entry, line_count, field);
  return static_cast<int>(cudaGetLastError());
}

// boxes: scratch of n_tiles x kClusters x 8 floats; n_tiles x 256 < 2^24
extern "C" int mbpol_direct_efp_bs(const float* sites, const float* mu, int n, int n_tiles,
                                   int row_tile0, int n_row_tiles, const int* tj,
                                   const int* meta, const int* row_start, float alpha,
                                   float cutoff2, float g_cc, float g_cd, float g_dd,
                                   float g_ddoh, float g_ddhh, float bx, float by, float bz,
                                   float* boxes, float* force, float* pot, float* e_row,
                                   void* stream) {
  if (n_tiles <= 0 || n_row_tiles <= 0) return 0;
  if ((long long)n_tiles * kTile > (1ll << kColBits) || row_tile0 < 0
      || row_tile0 + n_row_tiles > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c = make_consts(alpha, cutoff2, g_cc, g_cd, g_dd, g_ddoh, g_ddhh, bx, by, bz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_cluster_boxes(sites, n, n_tiles, c, boxes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  direct_efp_bs_kernel<<<n_row_tiles * kSubEfp, kThreads, 0, st>>>(
      sites, mu, n, row_tile0, tj, meta, row_start, c, reinterpret_cast<const float4*>(boxes),
      force, pot, e_row);
  return static_cast<int>(cudaGetLastError());
}
