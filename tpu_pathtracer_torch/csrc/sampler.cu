// Z-order Sobol draws (PBRT-v4's ZSobolSampler): for every lane, from its
// pixel, sample index and dimension, one float in [0, 1) (a 1-D draw) or
// two (a 2-D draw), bit for bit the plain version of
// tpu_pathtracer_torch/render/sampler.py.
//
// It replaces no TPU kernel: the JAX package's sampler is plain jnp
// (tpu_pathtracer/render/sampler.py), which XLA fuses into one loop.  In
// PyTorch the plain version runs its uint32 arithmetic as int64 tensor ops,
// one launch each with a mask after every one: ~430-520 launches a draw
// call, each reading and writing 8 bytes a lane.
//
// Bound: a lane reads its pixel (8 B), sample and dimension (4-8 B each,
// or nothing when they are scalars) and writes 4 or 8 B: ~5 MB over the
// 262,144 lanes of a wavefront tile, ~1.5 us at 3.35 TB/s.  Its integer
// work is ~300-500 32-bit operations a lane (one fmix32 a base-4 digit),
// a few microseconds on 132 SMs.  The design keeps the whole draw in
// registers: one thread a lane, every intermediate a uint32_t, so nothing
// but the operands and the draws touches memory.
//  * Sobol matrix 0 is a bit reversal; the Owen scramble starts and ends
//    with one, so the scramble takes the reversed value directly: the
//    sample index itself.
//  * Sobol matrix 1 (column k = (1 + x)^k over GF(2), reversed) is, by
//    Lucas' theorem, the superset sum over the 5-bit positions of the
//    index: five shift-mask-xor steps give its reversed value.
//  * The 24 base-4 digit permutations come in as three 64-bit words of
//    8-bit codes (kernel arguments), so picking one reads no memory.
//  * A digit whose shift is 32 or more sets only bits above the 32 the
//    Sobol product reads; the loop skips it (the plain version computes
//    it into the int64's upper bits, which nothing reads).
// The operands come as a pointer with a stride in 32-bit words, of which
// the lane reads the low word (an int32, or the low half of an int64: the
// low 32 bits, as the plain version's mask keeps), or as a value when the
// pointer is null.  A stride of 0 reads one word for every lane: a 0-d
// tensor on the card, filled before a captured graph's replay.
// The launch allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Operand {
    const int* ptr;         // null: every lane reads value
    long long stride;       // 32-bit words from one lane's word to the next
    uint32_t value;

    __device__ __forceinline__ uint32_t at(long long i) const {
        return ptr ? (uint32_t)__ldg(ptr + i * stride) : value;
    }
};

struct Pixels {
    const int* ptr;
    long long row, col;     // 32-bit words between lanes, between x and y
};

struct Params {
    uint32_t seed;          // the sampler's seed, low 32 bits
    int log2_spp;           // 0..31
    int n_digits;           // the base-4 digits of the Morton index, <= 31
    uint64_t codes[3];      // permutation p's code at bits 8 (p % 8) of
                            // word p / 8, digit d's image at bits 2d of it
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

__device__ __forceinline__ uint32_t spread16(uint32_t v) {
    v &= 0x0000FFFFu;
    v = (v ^ (v << 8)) & 0x00FF00FFu;
    v = (v ^ (v << 4)) & 0x0F0F0F0Fu;
    v = (v ^ (v << 2)) & 0x33333333u;
    v = (v ^ (v << 1)) & 0x55555555u;
    return v;
}

// the permuted base-4 digit scramble of the Morton index
__device__ __forceinline__ uint32_t sample_index(uint32_t morton,
                                                 uint32_t dim,
                                                 const Params& p) {
    const int pow2 = p.log2_spp & 1;
    const uint32_t dim_hash = dim * 0x55555555u;
    uint32_t idx = 0;
    for (int i = p.n_digits - 1; i >= pow2; --i) {
        const int shift = 2 * i - pow2;
        if (shift >= 32) continue;
        const uint32_t digit = (morton >> shift) & 3u;
        const uint32_t higher = shift + 2 < 32 ? morton >> (shift + 2) : 0u;
        const uint32_t perm = (fmix32(higher ^ dim_hash) >> 24) % 24u;
        const uint64_t word = perm < 8 ? p.codes[0]
                            : perm < 16 ? p.codes[1] : p.codes[2];
        const uint32_t permuted =
            (uint32_t)(word >> (8 * (perm & 7u) + 2 * digit)) & 3u;
        idx |= permuted << shift;
    }
    if (pow2) {
        const uint32_t flip = fmix32((morton >> 1) ^ dim_hash) & 1u;
        idx |= (morton & 1u) ^ flip;
    }
    return idx;
}

// FastOwenScrambler::randomize of the value whose bit reversal is r
__device__ __forceinline__ uint32_t owen_of_reversed(uint32_t r,
                                                     uint32_t seed) {
    r ^= r * 0x3D20ADEAu;
    r += seed;
    r *= (seed >> 16) | 1u;
    r ^= r * 0x05526C56u;
    r ^= r * 0x53A22864u;
    return __brev(r);
}

// Sobol matrix 1's product, bit-reversed
__device__ __forceinline__ uint32_t sobol1_reversed(uint32_t x) {
    x ^= (x >> 1) & 0x55555555u;
    x ^= (x >> 2) & 0x33333333u;
    x ^= (x >> 4) & 0x0F0F0F0Fu;
    x ^= (x >> 8) & 0x00FF00FFu;
    x ^= (x >> 16) & 0x0000FFFFu;
    return x;
}

// round to nearest, times 2^-32, at most the float below 1
__device__ __forceinline__ float unit_float(uint32_t v) {
    return fminf(__uint2float_rn(v) * 0x1p-32f, 0x1.fffffep-1f);
}

template <bool TWO_D>
__global__ void __launch_bounds__(THREADS)
zsobol_draw_kernel(int n, Pixels px, Operand sample, Operand dim, Params p,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const uint32_t x = (uint32_t)__ldg(px.ptr + i * px.row);
    const uint32_t y = (uint32_t)__ldg(px.ptr + i * px.row + px.col);
    const uint32_t morton =
        (((spread16(y) << 1) | spread16(x)) << p.log2_spp) | sample.at(i);
    const uint32_t d = dim.at(i);
    const uint32_t idx = sample_index(morton, d, p);
    // the permutation hashes dim, the scrambler dim + 1 (1-D), dim + 2 (2-D)
    const uint32_t s0 =
        fmix32((d + (TWO_D ? 2u : 1u)) * 0x9E3779B9u + p.seed);
    u_out[i] = unit_float(owen_of_reversed(idx, s0));
    if (TWO_D) {
        const uint32_t s1 = fmix32(s0 + 0x632BE59Bu);
        v_out[i] = unit_float(owen_of_reversed(sobol1_reversed(idx), s1));
    }
}

}  // namespace

extern "C" {

// Draws of n lanes.  px: (x, y) of lane i at words i * px_row and
// i * px_row + px_col; sample / dim: a pointer and stride as Operand, or
// the value where the pointer is null; codes: the three words of Params.
// v_out null: a 1-D draw into u_out; else a 2-D one into both.  Returns
// the launch's cudaError (0: queued on the stream).
int launch_zsobol_draw(int n, const void* px, long long px_row,
                       long long px_col, const void* sample,
                       long long sample_stride, unsigned sample_value,
                       const void* dim, long long dim_stride,
                       unsigned dim_value, unsigned seed, int log2_spp,
                       int n_digits, unsigned long long code0,
                       unsigned long long code1, unsigned long long code2,
                       void* u_out, void* v_out, void* stream) {
    if (n <= 0 || log2_spp < 0 || log2_spp > 31 || n_digits > 31)
        return (int)cudaErrorInvalidValue;
    const Pixels pixels{(const int*)px, px_row, px_col};
    const Operand s{(const int*)sample, sample_stride, sample_value};
    const Operand d{(const int*)dim, dim_stride, dim_value};
    const Params p{seed, log2_spp, n_digits, {code0, code1, code2}};
    const int blocks = (n + THREADS - 1) / THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (v_out)
        zsobol_draw_kernel<true><<<blocks, THREADS, 0, st>>>(
            n, pixels, s, d, p, (float*)u_out, (float*)v_out);
    else
        zsobol_draw_kernel<false><<<blocks, THREADS, 0, st>>>(
            n, pixels, s, d, p, (float*)u_out, nullptr);
    return (int)cudaGetLastError();
}

// out: [registers, local bytes a thread, resident blocks an SM, grid] of
// a launch over n lanes of the 1-D (two_d 0) or the 2-D kernel.
int zsobol_draw_launch_info(int two_d, int n, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = two_d
        ? cudaFuncGetAttributes(&attr, zsobol_draw_kernel<true>)
        : cudaFuncGetAttributes(&attr, zsobol_draw_kernel<false>);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    err = two_d
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &out[2], zsobol_draw_kernel<true>, THREADS, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &out[2], zsobol_draw_kernel<false>, THREADS, 0);
    out[3] = (n + THREADS - 1) / THREADS;
    return (int)err;
}

}  // extern "C"
