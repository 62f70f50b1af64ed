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
// e [P] and g = dE/dx [P, V]. No atomics: every sum runs in a fixed order,
// so results are bit-identical run to run, and a row's result does not
// depend on the batch around it. Tail rows are guarded in the kernels (no
// padded copy of x). All four run their contractions on the tensor cores
// (`wgmma`, bf16 operands split exactly from float32, float32 sums); a
// block is one warpgroup and owns 64 rows.
//
// What bounds them on the H100, at the water256 triplet batch (P ~ 40k
// rows, V = 36):
//  - exp/log, exact-product and vech quadratic forms (one body,
//    `quad_tc_body`, three bases): 2 P B^2 flops of the product
//    wm = m2 W (B = 703), which must keep float32 accuracy (the fit cancels
//    over three orders of magnitude); operations. The product runs on the
//    tensor cores as the TPU kernels run it on their matrix unit: m2 and W
//    are split exactly into three bf16 parts each and the six highest cross
//    products are summed in float32 (six `wgmma` passes, 989 / 6 TFLOP/s
//    against 67 on the CUDA cores). The block walks the output columns in
//    chunks of 176 (528 = 3 x 176, 704 = 4 x 176) with the chunk's wm in
//    registers. m2 never reaches shared memory: for each 16-deep K tile a
//    thread computes the 8 basis values of its A fragment from the block's
//    variables (two shared loads and a multiply, or an expf), splits them
//    in registers and feeds `wgmma` with A from registers; the epilogue
//    recomputes m2 the same way for e = sum m2 wm and z = 2 m2 wm. W's three
//    parts are tiled on the host in streaming order, each 16 x 176 tile in
//    the K-major core-matrix layout of `wgmma`, so one bulk asynchronous
//    copy (TMA, completion on an mbarrier) brings a stage of the ring. The
//    tensor core adds into its accumulator by truncation; a chain of 44 K
//    tiles x 6 passes would bias the cancelling sum. So each K tile's six
//    products are summed from zero, smallest first, and that partial sum is
//    added to the running sum on the CUDA cores (round to nearest). The
//    gradient z @ F runs on the tensor cores too: two column groups of the
//    accumulator layout are one K tile of the A layout, so z is split three
//    ways from registers to registers and multiplied with the chunk's
//    16 x 40 tiles of F (entries 0, 1, 2, exact in bf16: three exact
//    passes), summed from zero per chunk and added to the gradient so far on
//    the CUDA cores. Two blocks are resident per SM, so that one block's
//    basis, flush and epilogue overlap the other's products. The vech basis
//    differs in its input (transposed, so its loads are coalesced along the
//    rows) and in its factor pairs, which the block derives in closed form
//    from the natural vech order instead of reading an index table.
//    Measured and not kept: two-warpgroup blocks sharing one ring of W (half
//    the 2.97 MB of W each block streams from L2), building the next tile's
//    fragments under a tile's products, two half-chunk groups in flight in
//    turn, and the gradient through per-variable lists of basis rows in
//    shared memory (a latency-bound walk, a fifth of the time).
//  - monomial: P x 33,525 monomials, each four shared loads of log x, three
//    adds, an expf, a multiply and its share of a 3-way split; operations
//    (the CUDA cores' instruction issue and the shared-memory loads; the
//    expf alone would take a third of a millisecond on the transcendental
//    unit). The gradient g = (mc @ Et) / x is the gradient stage of the
//    quadratic forms with K the monomials: per tile of 16 monomials a thread
//    builds the 8 values mc = c exp(sum of four logs) of its A fragment
//    (rows r, r + 8 of its warp's 16; log x of both rows is one 8-byte
//    shared load at a byte offset the host table holds ready), splits them
//    three ways and issues three `wgmma` m64n40k16 against the tile of the
//    exponent matrix, which carries a column of ones so that the energy
//    falls out of the same product. Two tiles go into one sum of the
//    tensor core's accumulator (six passes from zero, smallest parts first,
//    as in the quadratic forms); that sum is added on the CUDA cores to a
//    float32 inner sum, which is added to the outer sum every 32 tiles: two
//    levels of float32 stay as close to float64 as the plain float32
//    evaluation (tools/pip_split_accuracy.py) at a tenth of the cost of
//    double sums. Waiting for a tile's products right after issuing them
//    cost a third of the time (the four warps of a warpgroup meet at every
//    `wgmma`), so the fragments are double-buffered: while the tensor cores
//    multiply one group of tiles the CUDA cores build the next one. The
//    monomials are ordered on the host so that the four monomials one shared
//    load serves hold the same or neighbouring variables (2.1 wavefronts per
//    8-byte load against 2.5 in the file's order; 2 is conflict-free). The
//    tiles of the exponent matrix (1,280 B), the factor offsets (256 B) and
//    the coefficients (64 B) stream in stages of 8 tiles through a ring of
//    bulk asynchronous copies; the whole table (3.4 MB) stays in L2. Four
//    blocks are resident per SM (128 registers). Measured and not kept:
//    `mma.sync` m16n8k16 per warp instead of `wgmma` (no meeting of the
//    warps, but 15 instructions and 10 shared loads a tile), 5 or 6 resident
//    blocks with a smaller ring, groups of 4 tiles at 2 blocks per SM.
//
// The C entry points take device pointers, sizes and the stream, allocate
// nothing and return the first CUDA error (0 = success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------
// Quadratic forms on the tensor cores (exp/log, exact-product and vech bases)
// ---------------------------------------------------------------------

enum Basis { kExpLog = 0, kProduct = 1, kVech = 2 };

constexpr int kQRows = 64;                  // rows per warpgroup (wgmma M)
constexpr int kWG = 128;                    // threads per warpgroup
constexpr int kNC = 176;                    // output columns per chunk (wgmma N)
constexpr int kKT = 16;                     // basis rows per W tile (wgmma K)
constexpr int kAcc = kNC / 2;               // accumulator registers per thread
constexpr int kSplitBytes = kKT * kNC * 2;  // one bf16 part of a W tile
constexpr int kStageBytes = 3 * kSplitBytes;
constexpr int kXS = 72;                     // floats per variable in xs (= 8 mod 32)
constexpr int kStages = 4;                  // ring of W tiles (~102 KB a block: two an SM)
constexpr int kNV = 40;                     // variables padded to the gradient's wgmma N
constexpr int kGAcc = kNV / 2;              // gradient accumulator registers per thread
constexpr int kFTileBytes = kKT * kNV * 2;  // one 16 x 40 tile of F
constexpr int kFChunkBytes = (kNC / kKT) * kFTileBytes;   // the F tiles of one chunk

// Shared memory: the ring of W tiles, the F tiles of the current chunk, the
// mbarriers (full[kStages], then the one of F), idx [bp] uint16, then the
// floats xs [v + 1][kXS] and gs [kGAcc][kWG] (a thread's gradient sums
// between chunks).
constexpr size_t kFOffset = (size_t)kStages * kStageBytes;
constexpr size_t kBarOffset = kFOffset + kFChunkBytes;
constexpr size_t kIdxOffset = kBarOffset + (kStages + 1) * 8;
__host__ __device__ constexpr size_t align_up(size_t n, size_t m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr size_t tc_xs_offset(int bp) {
  return align_up(kIdxOffset + 2 * (size_t)bp, 16);
}
size_t tc_smem_bytes(int v, int bp) {
  return tc_xs_offset(bp) + sizeof(float) * ((size_t)(v + 1) * kXS + kGAcc * kWG);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Bulk asynchronous copy global -> shared; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Two floats to packed bf16 (round to nearest even): lo in bits 0..15.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// Exact 3-way bf16 split of two floats: a = sum of the low halves of p[0..2],
// b = sum of the high halves (24 significand bits = 3 x 8; the residuals are
// exact in float32).
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  p0 = pack_bf16(a, b);
  a -= __uint_as_float(p0 << 16);
  b -= __uint_as_float(p0 & 0xffff0000u);
  p1 = pack_bf16(a, b);
  a -= __uint_as_float(p1 << 16);
  b -= __uint_as_float(p1 & 0xffff0000u);
  p2 = pack_bf16(a, b);
}

// Shared-memory matrix descriptor of a 16-deep B tile (a bf16 part of a W
// tile, or a tile of F): no swizzle, K-major; the two 8 x 8 core matrices
// (128 B each) of a group of 8 columns lie side by side along K (leading
// offset 128 B), groups 256 B apart (stride offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

// d (+)= A B: A 64 x 16 bf16 from registers, B 16 x 176 bf16 from shared
// memory, d 64 x 176 float32 (thread: rows g, g + 8 of its warp's 16,
// columns 8 j + 2 t, + 1 in d[4 j .. 4 j + 3]). scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n176(float (&d)[kAcc], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87}, "
      "{%88, %89, %90, %91}, %92, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B for the gradient: A 64 x 16 bf16 from registers, B 16 x 40 bf16
// (a tile of F) from shared memory, d 64 x 40 float32 in the same layout.
__device__ __forceinline__ void wgmma_n40(float (&d)[kGAcc], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Keeps registers that an asynchronous wgmma reads or writes out of the
// compiler's reordering across this point.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

// Basis value of one row from the packed factor indices ia | ib << 8; xr
// points at the row's slot of xs (kProduct: xa; kExpLog: log xa).
template <Basis kBasis>
__device__ __forceinline__ float basis_value(const float* xr, uint32_t idx) {
  const float fa = xr[(idx & 0xffu) * kXS], fb = xr[((idx >> 8) & 0xffu) * kXS];
  return kBasis == kExpLog ? expf(fa + fb) : fa * fb;
}

// The A fragments of K tile kt for rows r0, r0 + 8 (x0, x1: their slots of
// xs), each split three ways: a[part][register].
template <Basis kBasis>
__device__ __forceinline__ void build_frag(uint32_t (&a)[3][4], const float* x0, const float* x1,
                                           const uint32_t* idx2, int kt, int t) {
  const uint32_t w0 = idx2[kt * (kKT / 2) + t], w1 = idx2[kt * (kKT / 2) + t + 4];
  split3(basis_value<kBasis>(x0, w0), basis_value<kBasis>(x0, w0 >> 16), a[0][0], a[1][0],
         a[2][0]);
  split3(basis_value<kBasis>(x1, w0), basis_value<kBasis>(x1, w0 >> 16), a[0][1], a[1][1],
         a[2][1]);
  split3(basis_value<kBasis>(x0, w1), basis_value<kBasis>(x0, w1 >> 16), a[0][2], a[1][2],
         a[2][2]);
  split3(basis_value<kBasis>(x1, w1), basis_value<kBasis>(x1, w1 >> 16), a[0][3], a[1][3],
         a[2][3]);
}

// Offset of block i of the natural vech order over va augmented variables:
// row vech_offset(i, va) + j - i is the pair (i, j), i <= j.
__device__ __forceinline__ int vech_offset(int i, int va) { return i * va - i * (i - 1) / 2; }

// x [p, v] (kVech: xat [v + 1, p], the variables transposed, last row ones);
// idx [bp] packed factor indices (kVech: none, the block derives them);
// wtiles: the three bf16 parts of W in streaming order (bp / kNC chunks x
// bp / kKT tiles x kStageBytes); ftiles: F in 16 x 40 tiles, kFChunkBytes
// per chunk (ops/pip_fused.py, quad_kernel_tables, vech_kernel_tables). A
// block is one warpgroup and owns 64 rows.
template <Basis kBasis>
__device__ __forceinline__ void quad_tc_body(const float* __restrict__ x, int p, int v, int bp,
                                             const uint16_t* __restrict__ idx_g,
                                             const unsigned char* __restrict__ wtiles,
                                             const unsigned char* __restrict__ ftiles,
                                             float* __restrict__ e_out,
                                             float* __restrict__ g_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  const uint32_t fts = ring + kFOffset;                     // the chunk's tiles of F
  const uint32_t full0 = ring + kBarOffset;                 // full[kStages]
  const uint32_t ffull = full0 + 8 * kStages;
  uint16_t* idx_s = reinterpret_cast<uint16_t*>(smem_raw + kIdxOffset);
  float* xs = reinterpret_cast<float*>(smem_raw + tc_xs_offset(bp));
  const int tid = threadIdx.x;
  float* gs = xs + (v + 1) * kXS + tid;                     // z @ F so far: gs[i * kWG]
  const int nchunk = bp / kNC, nk = bp / kKT, total = nchunk * nk;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (kBasis == kVech) {
    // the factor pairs of the natural vech order, in closed form; the rows
    // that pad the basis to bp are 1 * 1 against zero rows of W
    const int va = v + 1;
    for (int i = tid; i < va; i += kWG) {
      uint16_t* row = idx_s + vech_offset(i, va) - i;
      for (int j = i; j < va; ++j) row[j] = static_cast<uint16_t>(i | j << 8);
    }
    for (int k = va * (va + 1) / 2 + tid; k < bp; k += kWG)
      idx_s[k] = static_cast<uint16_t>(v | v << 8);
  } else {
    for (int i = tid; i < bp; i += kWG) idx_s[i] = idx_g[i];
  }

  // the block's variables; tail rows get xa = 1
  const int row0 = blockIdx.x * kQRows;
  const int nrows = min(kQRows, p - row0);
  const size_t base = (size_t)row0 * v;
  if (kBasis == kVech) {                // rows of xat: coalesced along the batch
    for (int i = tid; i < kQRows * (v + 1); i += kWG) {
      const int a = i / kQRows, rr = i % kQRows;
      xs[a * kXS + rr] = rr < nrows ? x[(size_t)a * p + row0 + rr] : 1.0f;
    }
  } else {
    for (int i = tid; i < kQRows * v; i += kWG) {
      const int rr = i / v, a = i % v;
      const float val = rr < nrows ? x[base + i] : 1.0f;
      xs[a * kXS + rr] = kBasis == kExpLog ? logf(val) : val;
    }
    if (tid < kQRows) xs[v * kXS + tid] = kBasis == kExpLog ? 0.0f : 1.0f;
  }
  __syncthreads();

  if (tid == 0) {
    for (int s = 0; s < kStages && s < total; ++s) {
      mbar_expect_tx(full0 + 8 * s, kStageBytes);
      bulk_load(ring + s * kStageBytes, wtiles + (size_t)s * kStageBytes, kStageBytes,
                full0 + 8 * s);
    }
    mbar_expect_tx(ffull, kFChunkBytes);
    bulk_load(fts, ftiles, kFChunkBytes, ffull);
  }
  __syncwarp();

  // fragment coordinates: rows r0, r0 + 8 of the block's 64, K columns 2 t,
  // 2 t + 1, 2 t + 8, 2 t + 9 of a tile, output columns 8 j + 2 t, + 1
  const int lane = tid % 32, t = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const float* x0 = xs + r0;
  const float* x1 = xs + r0 + 8;
  const uint32_t* idx2 = reinterpret_cast<const uint32_t*>(idx_s);   // two basis rows a word

  float e0 = 0.0f, e1 = 0.0f;               // energy partials of rows r0, r0 + 8
#pragma unroll
  for (int i = 0; i < kGAcc; ++i) gs[i * kWG] = 0.0f;
  int it = 0, slot = 0;
  uint32_t parity = 0;
  float part[kAcc];                         // one K tile's six products
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = 0.0f;
  for (int c = 0; c < nchunk; ++c) {
    float acc[kAcc];                        // wm of the chunk, then z
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      uint32_t a[3][4];
      build_frag<kBasis>(a, x0, x1, idx2, kt, t);
      mbar_wait(full0 + 8 * slot, parity);
      const uint64_t w1d = b_desc(ring + slot * kStageBytes);
      const uint64_t w2d = w1d + (kSplitBytes >> 4), w3d = w2d + (kSplitBytes >> 4);
      // the six products of this tile from zero (scale_d = 0), smallest first
      fence_frag(a);
      fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_n176(part, a[0][0], a[0][1], a[0][2], a[0][3], w3d, 0);    // hi  x lo
      wgmma_n176(part, a[1][0], a[1][1], a[1][2], a[1][3], w2d, 1);    // mid x mid
      wgmma_n176(part, a[2][0], a[2][1], a[2][2], a[2][3], w1d, 1);    // lo  x hi
      wgmma_n176(part, a[0][0], a[0][1], a[0][2], a[0][3], w2d, 1);    // hi  x mid
      wgmma_n176(part, a[1][0], a[1][1], a[1][2], a[1][3], w1d, 1);    // mid x hi
      wgmma_n176(part, a[0][0], a[0][1], a[0][2], a[0][3], w1d, 1);    // hi  x hi
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(part);
      fence_frag(a);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];

      // every warp has left the slot: refill it with the tile kStages ahead
      __syncthreads();
      if (tid == 0 && it + kStages < total) {
        mbar_expect_tx(full0 + 8 * slot, kStageBytes);
        bulk_load(ring + slot * kStageBytes, wtiles + (size_t)(it + kStages) * kStageBytes,
                  kStageBytes, full0 + 8 * slot);
      }
      __syncwarp();
      if (++slot == kStages) {
        slot = 0;
        parity ^= 1;
      }
    }

    // epilogue of the chunk: e += m2 wm and z = 2 m2 wm in place of wm
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      const uint32_t w = idx2[(c * kNC + 8 * j + 2 * t) >> 1];
      const float m00 = basis_value<kBasis>(x0, w) * acc[4 * j];
      const float m01 = basis_value<kBasis>(x0, w >> 16) * acc[4 * j + 1];
      const float m10 = basis_value<kBasis>(x1, w) * acc[4 * j + 2];
      const float m11 = basis_value<kBasis>(x1, w >> 16) * acc[4 * j + 3];
      e0 += m00;
      e0 += m01;
      e1 += m10;
      e1 += m11;
      acc[4 * j] = 2.0f * m00;
      acc[4 * j + 1] = 2.0f * m01;
      acc[4 * j + 2] = 2.0f * m10;
      acc[4 * j + 3] = 2.0f * m11;
    }
    // gradient: z @ F for the chunk's basis rows, on the tensor cores. Two
    // column groups of the accumulator layout are one K tile of the A
    // layout, so z goes from registers to registers: split three ways
    // (F's entries 0, 1, 2 are exact in bf16, so three passes are exact
    // products), summed from zero over the chunk, smallest part first.
    // A tile's fragments stay untouched until its products are done.
    float gpart[kGAcc];
#pragma unroll
    for (int i = 0; i < kGAcc; ++i) gpart[i] = 0.0f;
    mbar_wait(ffull, c & 1);
#pragma unroll
    for (int jt = 0; jt < kNC / kKT; ++jt) {
      uint32_t zf[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split3(acc[8 * jt + 2 * q], acc[8 * jt + 2 * q + 1], zf[0][q], zf[1][q], zf[2][q]);
      const uint64_t fd = b_desc(fts + jt * kFTileBytes);
      fence_frag(zf);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_n40(gpart, zf[2], fd, jt > 0);
      wgmma_n40(gpart, zf[1], fd, 1);
      wgmma_n40(gpart, zf[0], fd, 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_frag(zf);
    }
    fence_acc(gpart);
#pragma unroll
    for (int i = 0; i < kGAcc; ++i) gs[i * kWG] += gpart[i];
    // every warp has read the chunk's tiles of F: bring the next chunk's
    __syncthreads();
    if (tid == 0 && c + 1 < nchunk) {
      mbar_expect_tx(ffull, kFChunkBytes);
      bulk_load(fts, ftiles + (size_t)(c + 1) * kFChunkBytes, kFChunkBytes, ffull);
    }
    __syncwarp();
  }

  // energy: the four column groups of a row, in a fixed order
  e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
  e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
  e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
  e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
  if (t == 0) {
    if (r0 < nrows) e_out[row0 + r0] = e0;
    if (r0 + 8 < nrows) e_out[row0 + r0 + 8] = e1;
  }
  // gradient: gs[4 j ..] = rows r0, r0 + 8 x variables 8 j + 2 t, + 1
#pragma unroll
  for (int j = 0; j < kNV / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rr = r0 + 8 * (q / 2), var = 8 * j + 2 * t + q % 2;
      if (rr < nrows && var < v) {
        const size_t o = base + (size_t)rr * v + var;
        g_out[o] = gs[(4 * j + q) * kWG] / (kBasis == kVech ? xs[var * kXS + rr] : x[o]);
      }
    }
  }
}

// Two blocks per SM: one block's flush, basis and epilogue overlap the
// other's products.
__global__ void __launch_bounds__(kWG, 2)
pip_quad_explog_kernel(const float* __restrict__ x, int p, int v, int bp,
                       const uint16_t* __restrict__ idx, const unsigned char* __restrict__ wtiles,
                       const unsigned char* __restrict__ ftiles, float* __restrict__ e_out,
                       float* __restrict__ g_out) {
  quad_tc_body<kExpLog>(x, p, v, bp, idx, wtiles, ftiles, e_out, g_out);
}

__global__ void __launch_bounds__(kWG, 2)
pip_quad_product_kernel(const float* __restrict__ x, int p, int v, int bp,
                        const uint16_t* __restrict__ idx, const unsigned char* __restrict__ wtiles,
                        const unsigned char* __restrict__ ftiles, float* __restrict__ e_out,
                        float* __restrict__ g_out) {
  quad_tc_body<kProduct>(x, p, v, bp, idx, wtiles, ftiles, e_out, g_out);
}

// xat [v + 1, p]; idx is not read (pass nullptr): one signature for the three.
__global__ void __launch_bounds__(kWG, 2)
pip_quad_vech_kernel(const float* __restrict__ xat, int p, int v, int bp,
                     const uint16_t* __restrict__ idx, const unsigned char* __restrict__ wtiles,
                     const unsigned char* __restrict__ ftiles, float* __restrict__ e_out,
                     float* __restrict__ g_out) {
  quad_tc_body<kVech>(xat, p, v, bp, idx, wtiles, ftiles, e_out, g_out);
}

// Dynamic shared memory above 48 KB must be asked for; the answer is checked.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The shared-memory attribute is set when the size asked for exceeds what
// this kernel was last granted (once per process for one polynomial).
template <Basis kBasis>
int run_quad_tc(const float* x, int p, int v, int bp, const void* idx, const void* wtiles,
                const void* ftiles, float* e, float* g, void* stream) {
  if (p <= 0) return 0;
  if (bp <= 0 || bp % kNC != 0 || v <= 0 || v > kNV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBasis == kVech && (v >= kNV || bp < (v + 1) * (v + 2) / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;
  const auto kernel = kBasis == kExpLog    ? pip_quad_explog_kernel
                      : kBasis == kProduct ? pip_quad_product_kernel
                                           : pip_quad_vech_kernel;
  const size_t bytes = tc_smem_bytes(v, bp);
  if (bytes > granted) {
    const cudaError_t rc = allow_smem(kernel, bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    granted = bytes;
  }
  kernel<<<(p + kQRows - 1) / kQRows, kWG, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, p, v, bp, static_cast<const uint16_t*>(idx), static_cast<const unsigned char*>(wtiles),
      static_cast<const unsigned char*>(ftiles), e, g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Monomial expansion: mc from registers, mc @ Et on the tensor cores
// ---------------------------------------------------------------------

constexpr int kMonoBlocks = 4;              // resident blocks per SM
constexpr int kMStageTiles = 8;             // tiles of 16 monomials per stage of the ring
constexpr int kMStages = 3;
constexpr int kMGroup = 2;                  // tiles summed in the tensor core's accumulator
constexpr int kMFlush = 32;                 // tiles per flush of the inner sums
constexpr int kEtBytes = kFTileBytes;       // a 16 x 40 bf16 tile of the exponent matrix
constexpr int kMOffBytes = kKT * 16;        // a tile's factor offsets: four int32 a monomial
constexpr int kMCoefBytes = kKT * 4;        // a tile's coefficients
constexpr int kMTileBytes = kEtBytes + kMOffBytes + kMCoefBytes;
constexpr int kMStageBytes = kMStageTiles * kMTileBytes;
static_assert(kXS * 4 == 288, "LA_STRIDE_BYTES of ops/pip_fused.py");
static_assert(kMFlush % kMStageTiles == 0, "the inner sums are flushed between stages");
constexpr int kMGroups = kMStageTiles / kMGroup;   // groups per stage
static_assert(kMStageTiles % kMGroup == 0 && kMGroups % 2 == 0,
              "a stage holds an even number of whole groups");

// Shared memory: the ring (per stage the tiles of Et, then the stage's
// factor offsets, then its coefficients), the mbarriers full[kMStages], then
// la [v + 1][kXS] = log x of the block's rows (slot v: log 1 = 0).
constexpr size_t kMBarOffset = (size_t)kMStages * kMStageBytes;
constexpr size_t kMLaOffset = align_up(kMBarOffset + kMStages * 8, 16);
size_t mono_smem_bytes(int v) { return kMLaOffset + sizeof(float) * (size_t)(v + 1) * kXS; }

// Slot of block row rr in a variable's kXS floats of la: the rows r, r + 8
// that one thread's fragments hold lie side by side (one 8-byte load).
__device__ __forceinline__ int la_slot(int rr) {
  return 2 * ((rr >> 4) * 8 + (rr & 7)) + ((rr >> 3) & 1);
}

// exp(sum of the four factor logs, in slot order) of one monomial for the
// two rows at lp (.x: row r, .y: row r + 8); k = the byte offsets of its
// four factors' logs from lp (factor index x kXS floats).
__device__ __forceinline__ float2 mono_pair(const unsigned char* lp, uint4 k) {
  const float2 a = *reinterpret_cast<const float2*>(lp + k.x);
  const float2 b = *reinterpret_cast<const float2*>(lp + k.y);
  const float2 c = *reinterpret_cast<const float2*>(lp + k.z);
  const float2 d = *reinterpret_cast<const float2*>(lp + k.w);
  return make_float2(expf(((a.x + b.x) + c.x) + d.x), expf(((a.y + b.y) + c.y) + d.y));
}

// The A fragments of one tile of 16 monomials for the rows r, r + 8 at lp:
// mc = c exp(...) of the monomials 2 t, 2 t + 1, 2 t + 8, 2 t + 9 (kw, cw:
// the offsets and the coefficients of the first pair), split three ways:
// a[part][register].
__device__ __forceinline__ void build_mono_frag(uint32_t (&a)[3][4], const unsigned char* lp,
                                                const uint4* kw, const float2* cw) {
  const float2 c0 = cw[0], c1 = cw[kKT / 4];
  const float2 m0 = mono_pair(lp, kw[0]), m1 = mono_pair(lp, kw[1]);
  const float2 m2 = mono_pair(lp, kw[8]), m3 = mono_pair(lp, kw[9]);
  split3(c0.x * m0.x, c0.y * m1.x, a[0][0], a[1][0], a[2][0]);
  split3(c0.x * m0.y, c0.y * m1.y, a[0][1], a[1][1], a[2][1]);
  split3(c1.x * m2.x, c1.y * m3.x, a[0][2], a[1][2], a[2][2]);
  split3(c1.x * m2.y, c1.y * m3.y, a[0][3], a[1][3], a[2][3]);
}

// x [p, v]; ettiles: the augmented exponent matrix (column v: ones) in
// ntiles 16 x 40 bf16 tiles, ntiles a multiple of kMStageTiles; offsets
// [16 ntiles] four int32 a monomial, its factor indices x kXS x 4 bytes
// (unused slots and padding: index v); coeffs [16 ntiles] (padding: 0)
// (ops/pip_fused.py, monomial_kernel_tables, which also chooses the
// monomials' order). A block is one warpgroup and owns 64 rows.
__global__ void __launch_bounds__(kWG, kMonoBlocks)
pip_monomial_kernel(const float* __restrict__ x, int p, int v,
                    const unsigned char* __restrict__ ettiles,
                    const unsigned char* __restrict__ offsets,
                    const unsigned char* __restrict__ coeffs, int ntiles,
                    float* __restrict__ e_out, float* __restrict__ g_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  const uint32_t full0 = ring + kMBarOffset;
  float* la = reinterpret_cast<float*>(smem_raw + kMLaOffset);
  const int tid = threadIdx.x;
  const int nstage = ntiles / kMStageTiles;

  // stage st of the tables into slot s of the ring: three copies, one barrier
  auto load_stage = [&](int s, int st) {
    const size_t t0 = (size_t)st * kMStageTiles;
    const uint32_t dst = ring + s * kMStageBytes, bar = full0 + 8 * s;
    mbar_expect_tx(bar, kMStageBytes);
    bulk_load(dst, ettiles + t0 * kEtBytes, kMStageTiles * kEtBytes, bar);
    bulk_load(dst + kMStageTiles * kEtBytes, offsets + t0 * kMOffBytes,
              kMStageTiles * kMOffBytes, bar);
    bulk_load(dst + kMStageTiles * (kEtBytes + kMOffBytes), coeffs + t0 * kMCoefBytes,
              kMStageTiles * kMCoefBytes, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kMStages; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // log x of the block's rows; tail rows get log 1
  const int row0 = blockIdx.x * kQRows;
  const int nrows = min(kQRows, p - row0);
  const size_t base = (size_t)row0 * v;
  for (int i = tid; i < kQRows * v; i += kWG) {
    const int rr = i / v, a = i % v;
    la[a * kXS + la_slot(rr)] = rr < nrows ? logf(x[base + i]) : 0.0f;
  }
  if (tid < kQRows) la[v * kXS + tid] = 0.0f;
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kMStages && s < nstage; ++s) load_stage(s, s);
  __syncwarp();

  // fragment coordinates: rows r0, r0 + 8 of the block's 64, monomials 2 t,
  // 2 t + 1, 2 t + 8, 2 t + 9 of a tile, output columns 8 j + 2 t, + 1
  const int lane = tid % 32, t = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const unsigned char* lp = reinterpret_cast<const unsigned char*>(la + la_slot(r0));

  // the fragments of group j (kMGroup tiles) of the stage in slot s
  auto build_group = [&](uint32_t (&f)[kMGroup][3][4], int s, int j) {
    const unsigned char* stage = smem_raw + s * kMStageBytes;
    const uint4* kw =
        reinterpret_cast<const uint4*>(stage + kMStageTiles * kEtBytes) + j * kMGroup * kKT + 2 * t;
    const float2* cw =
        reinterpret_cast<const float2*>(stage + kMStageTiles * (kEtBytes + kMOffBytes))
        + j * kMGroup * (kKT / 2) + t;
#pragma unroll
    for (int u = 0; u < kMGroup; ++u) build_mono_frag(f[u], lp, kw + u * kKT, cw + u * (kKT / 2));
  };

  float acc[kGAcc], run[kGAcc], part[kGAcc];    // outer sum, inner sum, one group
#pragma unroll
  for (int i = 0; i < kGAcc; ++i) acc[i] = run[i] = part[i] = 0.0f;
  // Two sets of fragments: while the tensor cores multiply one group, the
  // CUDA cores build the next one, also across the end of a stage (a stage
  // holds an even number of groups, so it starts with its first group in
  // a[0]).
  uint32_t a[2][kMGroup][3][4];
  mbar_wait(full0, 0);
  build_group(a[0], 0, 0);
  int slot = 0;
  uint32_t parity = 0;
  for (int st = 0; st < nstage; ++st) {
    const int next_slot = slot + 1 == kMStages ? 0 : slot + 1;
    const uint32_t next_parity = parity ^ (next_slot == 0);
#pragma unroll
    for (int j = 0; j < kMGroups; ++j) {
      uint32_t (&cur)[kMGroup][3][4] = a[j % 2];
      uint32_t (&nxt)[kMGroup][3][4] = a[(j + 1) % 2];
      // the group's exact passes from zero, smallest parts first
      const uint64_t ed = b_desc(ring + slot * kMStageBytes + j * kMGroup * kEtBytes);
#pragma unroll
      for (int u = 0; u < kMGroup; ++u) fence_frag(cur[u]);
      fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 2; s >= 0; --s)
#pragma unroll
        for (int u = 0; u < kMGroup; ++u)
          wgmma_n40(part, cur[u][s], ed + u * (kEtBytes >> 4), s < 2 || u > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (j + 1 < kMGroups) {
        build_group(nxt, slot, j + 1);
      } else if (st + 1 < nstage) {
        mbar_wait(full0 + 8 * next_slot, next_parity);
        build_group(nxt, next_slot, 0);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(part);
#pragma unroll
      for (int u = 0; u < kMGroup; ++u) fence_frag(cur[u]);
#pragma unroll
      for (int i = 0; i < kGAcc; ++i) run[i] += part[i];
    }
    if ((st + 1) % (kMFlush / kMStageTiles) == 0) {
#pragma unroll
      for (int i = 0; i < kGAcc; ++i) {
        acc[i] += run[i];
        run[i] = 0.0f;
      }
    }
    // every warp has left the slot: refill it with the stage kMStages ahead
    __syncthreads();
    if (tid == 0 && st + kMStages < nstage) load_stage(slot, st + kMStages);
    __syncwarp();
    slot = next_slot;
    parity = next_parity;
  }
#pragma unroll
  for (int i = 0; i < kGAcc; ++i) acc[i] += run[i];

  // acc[4 j ..] = rows r0, r0 + 8 x columns 8 j + 2 t, + 1: the variables'
  // dE/dlog x, and in column v the energy
#pragma unroll
  for (int j = 0; j < kNV / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rr = r0 + 8 * (q / 2), col = 8 * j + 2 * t + q % 2;
      if (rr < nrows && col < v) {
        const size_t o = base + (size_t)rr * v + col;
        g_out[o] = acc[4 * j + q] / x[o];
      } else if (rr < nrows && col == v) {
        e_out[row0 + rr] = acc[4 * j + q];
      }
    }
  }
}

}  // namespace

extern "C" int mbpol_pip_monomial(const float* x, int p, int v, const void* ettiles,
                                  const void* offsets, const void* coeffs, int ntiles,
                                  float* e, float* g, void* stream) {
  if (p <= 0) return 0;
  if (ntiles <= 0 || ntiles % kMStageTiles != 0 || v <= 0 || v >= kNV)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t granted = 0;
  const size_t bytes = mono_smem_bytes(v);
  if (bytes > granted) {
    const cudaError_t rc = allow_smem(pip_monomial_kernel, bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    granted = bytes;
  }
  pip_monomial_kernel<<<(p + kQRows - 1) / kQRows, kWG, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, p, v, static_cast<const unsigned char*>(ettiles),
      static_cast<const unsigned char*>(offsets), static_cast<const unsigned char*>(coeffs),
      ntiles, e, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbpol_pip_quad_explog(const float* x, int p, int v, int bp, const void* idx,
                                     const void* wtiles, const void* ftiles, float* e,
                                     float* g, void* stream) {
  return run_quad_tc<kExpLog>(x, p, v, bp, idx, wtiles, ftiles, e, g, stream);
}

extern "C" int mbpol_pip_quad_product(const float* x, int p, int v, int bp, const void* idx,
                                      const void* wtiles, const void* ftiles, float* e,
                                      float* g, void* stream) {
  return run_quad_tc<kProduct>(x, p, v, bp, idx, wtiles, ftiles, e, g, stream);
}

extern "C" int mbpol_pip_quad_vech(const float* xat, int p, int v, int bp, const void* wtiles,
                                   const void* ftiles, float* e, float* g, void* stream) {
  return run_quad_tc<kVech>(xat, p, v, bp, nullptr, wtiles, ftiles, e, g, stream);
}
