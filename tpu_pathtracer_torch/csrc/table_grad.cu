// The gradient of a gather from a small table: grad_table[m, c] = the sum,
// over the lanes whose row index is m, of grad_out[lane, c].
//
// It replaces no TPU kernel of the JAX package (there XLA derives the
// gather's transpose).  It takes the place of autograd's backward of
// ``table[idx]`` on the card, torch's ``index_put_`` with accumulate: a
// radix sort of the indices, then one warp per distinct row walking that
// row's lanes one after another.  A material table has a handful of rows
// and a tile 16,384 lanes or more, so that launch keeps about five warps
// of the card busy, each adding thousands of values in series.
//
// Bound: the bytes, each lane's index (8 B) and gradient (4 C B) read once,
// a few microseconds of launch at the sizes of a fit (16,384 lanes read
// 328 KB: 0.1 us at 3.35 TB/s).  The design spreads the lanes over many
// blocks and keeps every sum in a fixed order, with no float atomics, so a
// call gives the same bits every time and on every replay of a captured
// graph:
//  * each block takes a contiguous slice of lanes; for each row m every
//    thread sums its lanes of that row in lane order, a fixed tree of warp
//    shuffles and one of the block's warps gives the block's partial;
//  * the block that finishes last (an integer ticket, after a fence) adds
//    the blocks' partials in block order and writes the table's gradient.
// The row index may be negative, counted from the end, as torch's
// indexing takes it.  Lanes whose index lies outside the table add to no
// row.  The launch allocates nothing and does not synchronise: the caller
// hands it the partials, a zeroed ticket and the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES_PER_BLOCK = 4 * THREADS;
// two blocks an SM of the H100's 132; more lanes lengthen each slice
constexpr int MAX_BLOCKS = 264;
constexpr unsigned FULL = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(THREADS)
gather_rows_grad_kernel(int n, int rows, int per_block,
                        const long long* __restrict__ idx,
                        const float* __restrict__ grad,
                        float* __restrict__ partials,
                        unsigned int* __restrict__ ticket,
                        float* __restrict__ out) {
    __shared__ float warp_sum[WARPS][C];
    __shared__ bool last;
    const int start = blockIdx.x * per_block;
    const int end = min(n, start + per_block);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = 0; m < rows; ++m) {
        float acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.0f;
        for (int i = start + threadIdx.x; i < end; i += THREADS) {
            long long r = __ldg(idx + i);
            if (r < 0) r += rows;
            if (r == m) {
#pragma unroll
                for (int c = 0; c < C; ++c)
                    acc[c] += __ldg(grad + (int64_t)i * C + c);
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                acc[c] += __shfl_down_sync(FULL, acc[c], off);
        }
        if (lane == 0) {
#pragma unroll
            for (int c = 0; c < C; ++c) warp_sum[warp][c] = acc[c];
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float v = lane < WARPS ? warp_sum[lane][c] : 0.0f;
#pragma unroll
                for (int off = WARPS / 2; off > 0; off >>= 1)
                    v += __shfl_down_sync(FULL, v, off);
                if (lane == 0)
                    partials[(int64_t)(m * C + c) * gridDim.x + blockIdx.x] = v;
            }
        }
        __syncthreads();        // warp_sum is the next row's
    }
    // the partials visible to every block before this block's ticket
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int k = threadIdx.x; k < rows * C; k += THREADS) {
        const float* p = partials + (int64_t)k * gridDim.x;
        float s = 0.0f;
        for (int b = 0; b < (int)gridDim.x; ++b) s += __ldcg(p + b);
        out[k] = s;
    }
}

}  // namespace

extern "C" {

// The blocks of a launch over n lanes: the partials hold rows x channels x
// this many floats.
int gather_rows_grad_blocks(int n) {
    if (n <= 0) return 0;
    int blocks = (n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
    return blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS;
}

// idx: (n,) int64 row of each lane; grad: (n, channels) float32,
// contiguous; partials: (rows * channels * blocks) float32; ticket: one
// zeroed uint32; out: (rows, channels) float32.  channels is 1 or 3.
// Returns the launch's cudaError (0: queued on the stream).
int launch_gather_rows_grad(int n, int rows, int channels, const void* idx,
                            const void* grad, void* partials, void* ticket,
                            void* out, void* stream) {
    const int blocks = gather_rows_grad_blocks(n);
    if (blocks == 0 || rows <= 0) return (int)cudaErrorInvalidValue;
    const int per_block = (n + blocks - 1) / blocks;
    cudaStream_t s = (cudaStream_t)stream;
    const long long* i = (const long long*)idx;
    const float* g = (const float*)grad;
    float* p = (float*)partials;
    unsigned int* t = (unsigned int*)ticket;
    float* o = (float*)out;
    if (channels == 1)
        gather_rows_grad_kernel<1><<<blocks, THREADS, 0, s>>>(
            n, rows, per_block, i, g, p, t, o);
    else if (channels == 3)
        gather_rows_grad_kernel<3><<<blocks, THREADS, 0, s>>>(
            n, rows, per_block, i, g, p, t, o);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
