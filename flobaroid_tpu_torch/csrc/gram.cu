// Batched Gram G[b] = Y[:, b, :]^T Y[:, b, :] in f32 for NVIDIA Hopper (sm_90a).
//
// Replaces: flobaroid_tpu/ops/gram.py::_gram_kernel (the Pallas TPU kernel
// launched by gram_pallas). The TPU kernel streams row tiles through one
// resident (P, P) accumulator with a bf16 hi/lo split; this kernel computes
// the same product in plain f32 FMA, batched over B independent Grams
// (the per-output-channel Grams of the streamed identification, or B = 1
// for the structural Gram).
//
// What bounds it on this card: the Gram is a row stream into a tiny output.
// The full product is 2*C*C FLOP per row of 4*C bytes, i.e. 2*C/4 FLOP per
// byte of Y (41 at C = 82, 171 at C = 342); computing only the upper
// triangle halves that. Published peaks of the NVIDIA H100 SXM at its
// 700 W power limit (data sheet, not measured here): against the
// tensor-core ridge (TF32: 495 TFLOP/s /
// 3.35 TB/s ~ 148 FLOP/byte) the op is bound by bytes at the main path's
// C = 80..82. This first kernel deliberately stays on the CUDA cores in
// full f32 (67 TFLOP/s, ridge ~ 20 FLOP/byte), where the half-triangle
// intensity (C/4 ~ 20 at C = 82) sits at the ridge: FMA issue rate and
// bytes bound it about equally, and at the main path's small N the launch
// and the fill of 132 SMs matter more than either.
//
// What the design does about it:
//   * symmetry: only the nt*(nt+1)/2 upper-triangle 32x32 output tiles are
//     computed; the reduce pass mirrors them into the lower triangle;
//   * filling 132 SMs at small C: C = 82 has only 6 upper tiles per
//     channel, so the row axis is split across blocks too:
//     grid = (triangle tiles, B, row splits). Each block writes its partial
//     tile to a workspace; a second small kernel sums the partials in a
//     fixed order (in f64) and mirrors. No atomics, so the result is
//     bitwise reproducible from run to run, and the split also bounds each
//     thread's sequential f32 sum chain (the wrapper caps it at 2048 rows);
//   * strides are arguments: Y is read in whatever (N, B, C) layout the
//     caller built it in, with no transpose copy; coalesced along C.
// Speed beyond this (wgmma/TMA, split-TF32) is later work, chosen by
// accuracy first.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 32       // output tile edge (one warp wide)
#define ROWS 32       // rows of Y staged in shared memory per step
#define THREADS_Y 8   // block = (TILE, THREADS_Y) = 256 threads
#define PER_THREAD (TILE / THREADS_Y)

// upper-triangle tile index t -> (ti, tj) with ti <= tj, row-major
__device__ __forceinline__ void tile_coords(int t, int nt, int* ti, int* tj) {
    int i = 0;
    while (t >= nt - i) {
        t -= nt - i;
        ++i;
    }
    *ti = i;
    *tj = i + t;
}

__global__ void __launch_bounds__(TILE * THREADS_Y)
gram_partial_kernel(const float* __restrict__ Y, int64_t N, int B, int C,
                    int64_t sN, int64_t sB, int64_t sC, int nt,
                    int64_t rows_per_split, float* __restrict__ ws) {
    const int t = blockIdx.x;
    const int b = blockIdx.y;
    const int s = blockIdx.z;
    int ti, tj;
    tile_coords(t, nt, &ti, &tj);
    const int64_t r0 = (int64_t)s * rows_per_split;
    const int64_t r1 = (r0 + rows_per_split < N) ? r0 + rows_per_split : N;

    __shared__ float As[ROWS][TILE + 1];
    __shared__ float Bs[ROWS][TILE + 1];
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const float* Yb = Y + (int64_t)b * sB;
    const int ca = ti * TILE + tx;
    const int cb = tj * TILE + tx;
    const bool va = ca < C;
    const bool vb = cb < C;

    float acc[PER_THREAD];
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) acc[q] = 0.f;

    for (int64_t r = r0; r < r1; r += ROWS) {
#pragma unroll
        for (int k = ty; k < ROWS; k += THREADS_Y) {
            const int64_t row = r + k;
            const bool rv = row < r1;
            As[k][tx] = (rv && va) ? Yb[row * sN + (int64_t)ca * sC] : 0.f;
            Bs[k][tx] = (rv && vb) ? Yb[row * sN + (int64_t)cb * sC] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < ROWS; ++k) {
            const float bv = Bs[k][tx];
#pragma unroll
            for (int q = 0; q < PER_THREAD; ++q)
                acc[q] = fmaf(As[k][ty + q * THREADS_Y], bv, acc[q]);
        }
        __syncthreads();
    }

    const int T = nt * (nt + 1) / 2;
    float* out = ws + (((int64_t)s * B + b) * T + t) * (TILE * TILE);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
        out[(ty + q * THREADS_Y) * TILE + tx] = acc[q];
}

__global__ void gram_reduce_kernel(const float* __restrict__ ws, int S, int B,
                                   int C, int nt, float* __restrict__ out) {
    const int t = blockIdx.x;
    const int b = blockIdx.y;
    int ti, tj;
    tile_coords(t, nt, &ti, &tj);
    const int T = nt * (nt + 1) / 2;
    for (int e = threadIdx.x; e < TILE * TILE; e += blockDim.x) {
        const int i = e / TILE;
        const int j = e % TILE;
        const int gi = ti * TILE + i;
        const int gj = tj * TILE + j;
        if (gi >= C || gj >= C || (ti == tj && i > j)) continue;
        double sum = 0.0;
        for (int s = 0; s < S; ++s)
            sum += (double)ws[(((int64_t)s * B + b) * T + t) * (TILE * TILE) + e];
        const float v = (float)sum;
        out[((int64_t)b * C + gi) * C + gj] = v;
        out[((int64_t)b * C + gj) * C + gi] = v;
    }
}

// Y: (N, B, C) f32 with element strides (sN, sB, sC); ws: (S, B, T, 32, 32)
// f32 scratch; out: (B, C, C) f32 contiguous. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int gram_batched_f32(const float* Y, long long N, int B, int C,
                                long long sN, long long sB, long long sC,
                                long long rows_per_split, int S, float* ws,
                                float* out, void* stream) {
    const int nt = (C + TILE - 1) / TILE;
    const int T = nt * (nt + 1) / 2;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid1(T, B, S);
    dim3 block1(TILE, THREADS_Y);
    gram_partial_kernel<<<grid1, block1, 0, st>>>(Y, N, B, C, sN, sB, sC, nt,
                                                  rows_per_split, ws);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid2(T, B);
    gram_reduce_kernel<<<grid2, 256, 0, st>>>(ws, S, B, C, nt, out);
    return (int)cudaGetLastError();
}
