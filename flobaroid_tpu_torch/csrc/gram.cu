// Batched Gram G[b] = Y[:, b, :]^T Y[:, b, :] in f32 for NVIDIA Hopper
// (sm_90a): split-TF32 wgmma on the tensor cores, fed by TMA, one launch
// per call.
//
// Replaces: flobaroid_tpu/ops/gram.py::_gram_kernel (line 48), the Pallas
// TPU kernel launched by gram_pallas. It streams row tiles of Y through a
// resident (P, P) accumulator and splits y = hi + lo in bf16 so the MXU
// keeps f32-class accuracy (3.1e-6 of max|G|). This kernel keeps that
// idea with TF32 in place of bf16, batched over B independent Grams: the
// per-output-channel Grams of the streamed identification (tau and the
// contact column appended to C), and B = 1 for the structural Gram.
//
// What bounds it on this card (NVIDIA H100 SXM: 3.35 TB/s, 495 TFLOP/s
// TF32 dense; data sheet). Y is read once; the f32 work of the symmetric
// product is N*B*C*(C+1) FLOP, counted against the TF32 peak, the fastest
// unit an f32-accurate route can use:
//
//   N x B x C             bytes of Y  bytes bound  ops bound  bound
//   14 000 x 1 x 80        4.48 MB     1.3 us       0.18 us    bytes
//   4 096 x 7 x 82         9.40 MB     2.8 us       0.39 us    bytes
//   60 000 x 7 x 82        137.8 MB    41 us        5.8 us     bytes
//   13 770 x 30 x 342      565 MB      169 us       98 us      bytes
//
// So the op is a row stream, bound by bytes, and at the main path's small
// N by the launch. What the design does about that:
//   * Tensor cores with a two-term split. hi = cvt.rna.tf32(y),
//     lo = cvt.rna.tf32(y - hi); G = Hi^T Hi + Hi^T Lo + Lo^T Hi, all
//     three wgmma (m64nNk8, tf32) products into one f32 accumulator.
//     Lo^T Lo (~2^-22 relative) is dropped. Three TF32 passes are 3x the
//     symmetric product's FLOP at the TF32 peak: under the bytes bound at
//     C <= 128 (17 us against 41 us at 60 000 x 7 x 82), above it at
//     C = 342 (294 us against 169 us), where the tensor work, not the
//     bytes, is this design's floor. The TF32 split was chosen over a
//     bf16 three-term split because two terms suffice for 1e-6 and the
//     transpose it needs is free: see the next point.
//   * K-major operands. tf32 wgmma reads both operands K-major from shared
//     memory (the transpose flags exist only for 16-bit types). K is the
//     row axis of Y, and Y is C-contiguous, so the raw tile is MN-major.
//     The split pass goes through registers anyway: it reads the raw tile
//     column-wise and writes hi and lo transposed, one 16-byte chunk of 4
//     rows at a time, into the 128-byte-swizzled K-major layout wgmma
//     reads (column c, row k at c*128 + ((k/4 ^ c%8)*16) + (k%4)*4). Both
//     operands of the Gram are the same columns of Y, so one split buffer
//     serves as A and as B.
//   * Tensor-core accumulation need not round to nearest (published
//     studies of earlier NVIDIA tensor cores found truncation), so every
//     32-row step's three products go to a fresh register accumulator
//     (scale-d = 0 on the first wgmma), which is added into the block's
//     running f32 sum on the CUDA cores (round to nearest). The tensor
//     cores' chain stays 12 wgmma long whatever N is.
//   * Asynchronous copies: one producer warp keeps a ring of 3-4
//     shared-memory stages full with TMA (cp.async.bulk.tensor, mbarrier
//     completion). Y is read through a 3-D tensor map (C, B, N), which
//     needs 16-byte-aligned row and channel strides. The two Gram sites
//     of the main path build Y in a buffer whose rows are padded with zero
//     columns to a multiple of 4 floats and pass the unpadded view
//     (ops/gram.py::cat_padded); the map's C is the true width, so TMA
//     fills the columns past C with zeros. Any other layout is first
//     copied into such a buffer by the wrapper.
//   * The split of step i+1 overlaps the wgmma of step i: two split
//     buffers, one consumer barrier per step.
//   * Tiling matched to C. C <= 128 (the main path: 80 and 82): one tile
//     per (channel, row split) holds the whole C x C (C rounded up to 32)
//     in registers: one consumer warpgroup for C <= 64, else two, the
//     second computing only its columns >= 64 (the rest is the mirror).
//     C > 128: 128 x 128 upper-triangle tiles over pairs of column panels;
//     the tiles of one (channel, row range) are neighbouring blocks, so
//     the panels they share are re-read from the 50 MB L2.
//   * One launch, bitwise reproducible. The row axis is split across
//     blocks so that the blocks fill the 132 SMs (the wrapper's planner
//     picks the split count). Each block writes its partial tile; the last
//     block to finish a tile, found by a per-tile arrival counter, sums
//     every partial in split order in f64, writes the tile and its mirror,
//     and resets the counter. No atomics on values.
//
// History: the first port of this kernel (the previous revision of this
// file) ran on the CUDA cores in plain f32 FMA: 32 x 32 upper-triangle
// tiles, a 256-thread block with 4 accumulators a thread, synchronous
// 4-byte loads into shared memory with no pipelining, the row axis split
// across blocks and a second kernel summing the partials in f64. It was
// right (<= 8e-7 of max|G|) but bound by shared-memory loads (5 loads for
// 4 FMA) at a seventh of the TF32 rate, and 1.7x slower than cuBLAS at
// C = 342.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;          // rows of Y per pipeline step: one 128-byte swizzle row of K
constexpr int PAIR_TILE = 128;  // output tile edge for C > 128

template <int NP, bool PAIRS>
struct Cfg {
    static constexpr int NWG = (PAIRS || NP > 64) ? 2 : 1;  // consumer warpgroups
    static constexpr int NC = NWG * 128;                      // consumer threads
    static constexpr int THREADS = NC + 32;                   // + one producer warp
    static constexpr int STAGES = PAIRS ? 3 : 4;
    static constexpr int PANELS = PAIRS ? 2 : 1;
    static constexpr int TILE_ROWS = NWG * 64;
    static constexpr int PANEL_RAW = NP * BK * 4;  // one TMA box (BK rows x NP columns), bytes
    // one K-major operand (hi or lo of a panel); rows past NP are read by
    // the second warpgroup's A rows only and land in output rows >= C
    static constexpr int PANEL_OPND = (NP > TILE_ROWS ? NP : TILE_ROWS) * BK * 4;
    static constexpr int RAW_STAGE = PANELS * PANEL_RAW;
    static constexpr int SPLIT_BUF = PANELS * 2 * PANEL_OPND;
    static constexpr int TILE_ELEMS = TILE_ROWS * NP;
    static_assert(NP * (BK / 4) % NC == 0, "split items divide evenly over the consumers");
    static constexpr int SMEM = 1024 + STAGES * RAW_STAGE + 2 * SPLIT_BUF + 2 * STAGES * 8 + 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

// the retry loop stays inside the asm, so the compiler sees no divergent
// branch around the warpgroup's wgmma
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void consumer_sync(int nthreads) {
    asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ float to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset (unused for this layout), 1024
// bytes between groups of 8 rows, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma's issue and wait
template <int R>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N) (+)= A(64 x 8) B(8 x N), tf32 in, f32 accumulate, both
// operands K-major in shared memory; scale_d = 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
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
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// one 32-row step: Hi^T Hi + Hi^T Lo + Lo^T Hi over 4 k8 slices; the first
// wgmma overwrites the step accumulator
template <int N>
__device__ __forceinline__ void step_products(float* d, uint32_t a_hi, uint32_t a_lo,
                                              uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t o = kk * 32;  // 8 tf32 of K = 32 bytes along the swizzled row
        wgmma_tf32<N>(d, kmajor_desc(a_hi + o), kmajor_desc(b_hi + o), kk > 0);
        wgmma_tf32<N>(d, kmajor_desc(a_hi + o), kmajor_desc(b_lo + o), 1);
        wgmma_tf32<N>(d, kmajor_desc(a_lo + o), kmajor_desc(b_hi + o), 1);
    }
}

// One consumer warpgroup's run over its block's rows: wait for a stage,
// split it (all consumer threads share that work), fold the previous
// step's products, then issue this step's products asynchronously so
// they overlap the next step's split. N is the warpgroup's wgmma width:
// NP, or NP - 64 for the second warpgroup of a diagonal tile, which
// computes the tile's columns from NP - N on. Writes the warpgroup's rows
// of the block's partial tile to `mine`.
template <int NP, bool PAIRS, int N>
__device__ __forceinline__ void consume(const uint8_t* raw, uint8_t* split, uint64_t* full,
                                        uint64_t* empty, int nk, bool diag, int wg, int tid,
                                        float* mine) {
    using K = Cfg<NP, PAIRS>;
    constexpr int R = N / 2;        // f32 registers of an m64nN accumulator
    constexpr int COL0 = NP - N;    // first tile column of this warpgroup
    float acc[R], part[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = part[i] = 0.f;

    for (int it = 0; it < nk; ++it) {
        const int st = it % K::STAGES;
        mbar_wait(smem_u32(&full[st]), (it / K::STAGES) & 1);

        // split y = hi + lo and write both transposed (K-major, swizzled):
        // item = (group g of 4 rows, column c) of each panel; a warp reads
        // 32 neighbouring columns of a row and writes 16-byte chunks that
        // the swizzle spreads over all banks
        const float* src = reinterpret_cast<const float*>(raw + st * K::RAW_STAGE);
        uint8_t* dst = split + (it & 1) * K::SPLIT_BUF;
#pragma unroll
        for (int p = 0; p < K::PANELS; ++p) {
            if (p == 1 && diag) break;
#pragma unroll
            for (int j = 0; j < NP * (BK / 4) / K::NC; ++j) {
                const int item = tid + j * K::NC;
                const int g = item / NP;
                const int c = item - g * NP;
                const float* y = src + p * (K::PANEL_RAW / 4) + 4 * g * NP + c;
                float4 h, l;
                h.x = to_tf32(y[0]);
                h.y = to_tf32(y[NP]);
                h.z = to_tf32(y[2 * NP]);
                h.w = to_tf32(y[3 * NP]);
                l.x = to_tf32(y[0] - h.x);
                l.y = to_tf32(y[NP] - h.y);
                l.z = to_tf32(y[2 * NP] - h.z);
                l.w = to_tf32(y[3 * NP] - h.w);
                uint8_t* opnd = dst + p * 2 * K::PANEL_OPND + c * 128 + ((g ^ (c & 7)) << 4);
                *reinterpret_cast<float4*>(opnd) = h;
                *reinterpret_cast<float4*>(opnd + K::PANEL_OPND) = l;
            }
        }
        mbar_arrive(smem_u32(&empty[st]));
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

        // the previous step's products are done: fold them into the
        // running sum (round to nearest); the barrier then releases the
        // split buffer they read to the next step's split
        if (it > 0) {
            wgmma_wait_all();
            reg_fence<R>(part);
#pragma unroll
            for (int i = 0; i < R; ++i) acc[i] += part[i];
        }
        consumer_sync(K::NC);

        const uint32_t a_hi = smem_u32(dst) + wg * 64 * 128;
        const uint32_t a_lo = a_hi + K::PANEL_OPND;
        const uint32_t b_hi = smem_u32(dst) + (diag ? 0 : 2 * K::PANEL_OPND) + COL0 * 128;
        const uint32_t b_lo = b_hi + K::PANEL_OPND;
        reg_fence<R>(part);
        wgmma_fence();
        step_products<N>(part, a_hi, a_lo, b_hi, b_lo);
        wgmma_commit();
    }
    wgmma_wait_all();
    reg_fence<R>(part);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += part[i];

    // wgmma's accumulator layout: register 4i + {0,1} at (row,
    // 8i + 2(lane%4) + {0,1}), 4i + {2,3} at row + 8
    const int lane = tid % 32;
    const int row = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int col = COL0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
        *reinterpret_cast<float2*>(mine + row * NP + col + 8 * i) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<float2*>(mine + (row + 8) * NP + col + 8 * i) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
}

// grid: one block per (row split s, channel b, tile t), s slowest
template <int NP, bool PAIRS>
__global__ void __launch_bounds__(Cfg<NP, PAIRS>::THREADS, 1)
gram_tf32_kernel(const __grid_constant__ CUtensorMap tmap, int N, int B, int C, int T, int nt,
                 int rows_per_split, int S, float* __restrict__ ws, int* __restrict__ counters,
                 float* __restrict__ out) {
    using K = Cfg<NP, PAIRS>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* raw = smem;                               // [STAGES][PANELS][BK][NP] f32, as TMA wrote it
    uint8_t* split = raw + K::STAGES * K::RAW_STAGE;   // [2][PANELS][hi, lo] K-major tf32
    uint64_t* full = reinterpret_cast<uint64_t*>(split + 2 * K::SPLIT_BUF);
    uint64_t* empty = full + K::STAGES;
    volatile int* last_flag = reinterpret_cast<volatile int*>(empty + K::STAGES);

    const int t = blockIdx.x % T;
    const int b = (blockIdx.x / T) % B;
    const int s = blockIdx.x / (T * B);
    int ti = 0, tj = 0;
    if (PAIRS) {
        int r = t;
        while (r >= nt - ti) {
            r -= nt - ti;
            ++ti;
        }
        tj = ti + r;
    }
    const bool diag = ti == tj;
    const int r0 = s * rows_per_split;
    const int r1 = min(r0 + rows_per_split, N);
    const int nk = (r1 - r0 + BK - 1) / BK;
    const int tid = threadIdx.x;
    // warp-uniform as far as the compiler can see (a shuffle from lane 0),
    // so the role branches do not make it serialize the wgmma
    const int warp = __shfl_sync(0xffffffff, tid / 32, 0);

    if (tid == 0) {
        for (int i = 0; i < K::STAGES; ++i) {
            mbar_init(smem_u32(&full[i]), 1);
            mbar_init(smem_u32(&empty[i]), K::NC);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= K::NC / 32) {
        // producer warp: one lane keeps the ring of TMA loads full; rows
        // past N arrive as zeros (the map's bounds), and every split but
        // the last is a whole number of BK-row steps
        if (tid == K::NC) {
            const uint32_t bytes = (diag ? 1 : 2) * K::PANEL_RAW;
            for (int it = 0; it < nk; ++it) {
                const int st = it % K::STAGES;
                mbar_wait(smem_u32(&empty[st]), ((it / K::STAGES) & 1) ^ 1);
                const uint32_t bar = smem_u32(&full[st]);
                mbar_arrive_expect_tx(bar, bytes);
                const uint32_t dst = smem_u32(raw + st * K::RAW_STAGE);
                const int k0 = r0 + it * BK;
                tma_load_3d(dst, &tmap, bar, ti * PAIR_TILE, b, k0);
                if (!diag) tma_load_3d(dst + K::PANEL_RAW, &tmap, bar, tj * PAIR_TILE, b, k0);
            }
        }
        return;
    }

    // consumers: warpgroup wg computes output rows [64 wg, 64 wg + 64) of
    // the tile; in a diagonal tile the second warpgroup computes only the
    // columns >= 64 (the lower triangle is the mirror). Each width is its
    // own instantiation, so no accumulator is shared between two wgmma
    // shapes and no branch sits inside the pipelined loop.
    const int wg = warp / 4;
    float* mine = ws + ((size_t)(s * B + b) * T + t) * K::TILE_ELEMS;
    if constexpr (K::NWG == 2) {
        if (diag && wg == 1)
            consume<NP, PAIRS, NP - 64>(raw, split, full, empty, nk, diag, wg, tid, mine);
        else
            consume<NP, PAIRS, NP>(raw, split, full, empty, nk, diag, wg, tid, mine);
    } else {
        consume<NP, PAIRS, NP>(raw, split, full, empty, nk, diag, wg, tid, mine);
    }
    __threadfence();
    consumer_sync(K::NC);
    if (tid == 0) {
        const int prev = atomicAdd(&counters[b * T + t], 1);
        const int last = prev == S - 1;
        if (last) counters[b * T + t] = 0;  // ready for the next call on this stream
        *last_flag = last;
    }
    consumer_sync(K::NC);
    if (!*last_flag) return;
    __threadfence();

    // the last block of the tile: every partial in split order, in f64,
    // four columns at a time
    const int gi0 = ti * PAIR_TILE, gj0 = tj * PAIR_TILE;
    const size_t split_stride = (size_t)B * T * K::TILE_ELEMS;
    const float* first = ws + ((size_t)b * T + t) * K::TILE_ELEMS;
    for (int e = 4 * tid; e < K::TILE_ELEMS; e += 4 * K::NC) {
        const int i = e / NP;
        const int j = e - i * NP;
        const int gi = gi0 + i, gj = gj0 + j;
        if (gi >= C || gj >= C || (diag && i > j + 3)) continue;
        double sum[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
        for (int sp = 0; sp < S; ++sp) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(first + sp * split_stride + e));
            sum[0] += v.x;
            sum[1] += v.y;
            sum[2] += v.z;
            sum[3] += v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (gj + q >= C || (diag && i > j + q)) continue;
            const float v = (float)sum[q];
            out[((size_t)b * C + gi) * C + gj + q] = v;
            out[((size_t)b * C + gj + q) * C + gi] = v;
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, fetched through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                         cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

template <int NP, bool PAIRS>
int launch(const CUtensorMap& map, int N, int B, int C, int T, int nt, int rows, int S,
           float* ws, int* counters, float* out, cudaStream_t st) {
    using K = Cfg<NP, PAIRS>;
    static_assert(K::SMEM <= 232448, "shared memory of one block");
    auto kern = gram_tf32_kernel<NP, PAIRS>;
    static unsigned long long smem_set = 0;  // one bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !((smem_set >> dev) & 1)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
        if (e != cudaSuccess) return (int)e;
        if (dev < 64) smem_set |= 1ull << dev;
    }
    kern<<<S * B * T, K::THREADS, K::SMEM, st>>>(map, N, B, C, T, nt, rows, S, ws, counters, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Y: (N, B, C) f32 with element strides (sN, sB, 1), sN and sB multiples
// of 4 and Y 16-byte aligned; np: the panel width (32, 64, 96 or 128;
// pairs = 1 for C > 128, np = 128); rows_per_split a multiple of 32 with
// S splits covering N; ws: S * B * T tiles of the kernel's tile size f32
// scratch; counters: B * T int32, zero on entry and left zero; out:
// (B, C, C) f32 contiguous. Launches once on `stream` without
// synchronising. Returns 0, a cudaError_t, -1 when the driver's tensor-map
// encoder is unavailable, -2 for an unsupported np, or 100000 + the
// CUresult of a refused tensor map.
extern "C" int gram_batched_f32(const float* Y, long long N, int B, int C, long long sN,
                                long long sB, int np, int pairs, long long rows_per_split, int S,
                                float* ws, int* counters, float* out, void* stream) {
    EncodeTiled encode = encode_tiled();
    if (!encode) return -1;
    const int nt = pairs ? (C + PAIR_TILE - 1) / PAIR_TILE : 1;
    const int T = nt * (nt + 1) / 2;
    cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)B, (cuuint64_t)N};
    cuuint64_t strides[2] = {(cuuint64_t)sB * 4, (cuuint64_t)sN * 4};
    cuuint32_t box[3] = {(cuuint32_t)(pairs ? PAIR_TILE : np), 1, (cuuint32_t)BK};
    cuuint32_t elem_strides[3] = {1, 1, 1};
    CUtensorMap map;
    CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)Y, dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
    cudaStream_t st = (cudaStream_t)stream;
    const int n = (int)N, rows = (int)rows_per_split;
    if (pairs) return launch<128, true>(map, n, B, C, T, nt, rows, S, ws, counters, out, st);
    switch (np) {
        case 32: return launch<32, false>(map, n, B, C, T, nt, rows, S, ws, counters, out, st);
        case 64: return launch<64, false>(map, n, B, C, T, nt, rows, S, ws, counters, out, st);
        case 96: return launch<96, false>(map, n, B, C, T, nt, rows, S, ws, counters, out, st);
        case 128: return launch<128, false>(map, n, B, C, T, nt, rows, S, ws, counters, out, st);
        default: return -2;
    }
}
