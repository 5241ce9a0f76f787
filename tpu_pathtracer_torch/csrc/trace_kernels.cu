// Ray traversal kernels for Hopper (sm_90a): closest hit and any hit, each
// with the fast unit-triangle test (K1, K2) and with the precise watertight
// shear test (K3, K2p).
//
// Replace the TPU kernels of tpu_pathtracer/ops/pallas_trace.py:
//   closest_hit_kernel         <- _kernel_closest_fast (with _block_test_fast
//                                 and the packed-key decode in traverse)
//   any_hit_kernel             <- _kernel_anyhit (its fast, precise=False form)
//   closest_hit_precise_kernel <- _kernel_closest (with _ray_setup,
//                                 _block_test and _diff_of_products)
//   any_hit_precise_kernel     <- _kernel_anyhit (its precise=True form)
//
// Design.  The TPU kernels test every ray of a 64-ray subtile against
// dense 128-triangle blocks held in VMEM, because TPU gathers run as a
// scalar loop.  On Hopper a gather is an ordinary load, so each thread
// walks the flat BVH for one ray: pop a node ref from a per-thread stack,
// test both child boxes of an internal node (rows of nodes_f / nodes_i)
// and push the hit children far-first, or test the <= 7 triangles of an
// inline leaf: their unit-triangle transform rows (tri_m12) in the fast
// kernels, their vertex rows (tri9) in the precise ones.
//
// Fast hit test (K1, K2; the same arithmetic as the plain PyTorch version in
// ops/cuda_trace.py, term for term and in the same order; build with
// --fmad=false so no multiply-add is contracted and the two agree bit for
// bit):  [o,1] and [d,0] in triangle coordinates give t = -o_w / d_w,
// u = o_u + t d_u, v = o_v + t d_v; a hit needs u, v >= 0, u + v <= 1 and
// 1e-6 < t < t_max.  Closest hit keeps the smallest t and, where t ties
// exactly, the lower triangle id (the plain version's first-index argmin).
// The TPU kernel's 7-mantissa-bit tie window is not reproduced.
//
// Box test: PBRT's slab test with the far distance scaled by 1 + 2 gamma(3),
// and a box is culled only when its entry distance exceeds the current
// bound by more than T_SLACK.  The fast hit test's t carries an error that
// grows as the ray grazes the triangle's plane (measured on the H100 run of
// chip_smoke.py: shadow rays grazing the light quad, t off by ~5e-5
// relative); without the slack the walk culls triangles whose fast test
// the brute-force plain version counts as hits below t_max.
//
// Precise hit test (K3, K2p; the arithmetic of _ray_setup and _block_test,
// term for term): per ray, the axis kz of the largest |d| (ties as in
// _ray_setup: x wins over z, y over x and z) becomes z and the shear
// constants sx, sy, sz follow; per triangle, the vertices are translated to
// the ray origin, permuted and sheared, the three edge functions are
// Dekker-compensated differences of products (split 4097; their sign is
// exact, which needs --fmad=false), and a hit needs all three on one side,
// det != 0, the sign-consistent bound test of t_scaled against t_max * det
// before the divide, and t = t_scaled / det > 1e-6.  The bound test uses
// the ray's own t_max, not the shrinking best t, so that the closest hit is
// the plain version's: the smallest t among the hits, the lower id on an
// exact tie.  The nine vertex floats are scalar __ldg loads from tri9
// (36-byte rows are not 16-byte aligned); the axis permutation is folded
// into the load address (row[3 v + k]).  The box cull keeps the padded far
// distance and T_SLACK: the precise t is tight, but a triangle lying in a
// box face can still lose its box to slab rounding.
//
// What bounds it: per-ray work is data-dependent (node visits and
// triangle tests), and the loads are scattered gathers from ~1.2 MB of
// node and triangle tables that stay in L2.  With `counters` given, each
// thread adds its node visits and triangle tests to counters[0] and
// counters[1], from which a caller computes the least operation count
// and bytes of the call.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_STACK 64    // must match cuda_trace.MAX_STACK
#define BLOCK_THREADS 128
#define T_SLACK 1.001f  // relative slack of the box cull against t_lim

struct Ray {
    float ox, oy, oz, dx, dy, dz, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int n, int i) {
    Ray r;
    r.ox = rays[i];
    r.oy = rays[n + i];
    r.oz = rays[2 * n + i];
    r.dx = rays[3 * n + i];
    r.dy = rays[4 * n + i];
    r.dz = rays[5 * n + i];
    r.tmax = rays[6 * n + i];
    return r;
}

// Slab test of one box [lo, hi] against the ray, conservative.
__device__ __forceinline__ bool box_hit(float lox, float loy, float loz,
                                        float hix, float hiy, float hiz,
                                        const Ray& r, float ix, float iy,
                                        float iz, float t_lim, float& t_near) {
    float t0x = (lox - r.ox) * ix, t1x = (hix - r.ox) * ix;
    float t0y = (loy - r.oy) * iy, t1y = (hiy - r.oy) * iy;
    float t0z = (loz - r.oz) * iz, t1z = (hiz - r.oz) * iz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    tf = tf * 1.00000036f;  // 1 + 2 gamma(3)
    t_near = tn;
    return (tn <= tf) && (tf > 0.0f) && (tn <= t_lim * T_SLACK);
}

// Unit-triangle transform test; m is the 12-float row of tri_m12.
__device__ __forceinline__ bool tri_test(const float* __restrict__ tri_m12,
                                         int tri, const Ray& r, float& t,
                                         float& u, float& v) {
    const float4* row = reinterpret_cast<const float4*>(tri_m12 + 12 * (size_t)tri);
    float4 mu = __ldg(row), mv = __ldg(row + 1), mw = __ldg(row + 2);
    float ou = r.ox * mu.x + r.oy * mu.y + r.oz * mu.z + mu.w;
    float ov = r.ox * mv.x + r.oy * mv.y + r.oz * mv.z + mv.w;
    float ow = r.ox * mw.x + r.oy * mw.y + r.oz * mw.z + mw.w;
    float du = r.dx * mu.x + r.dy * mu.y + r.dz * mu.z;
    float dv = r.dx * mv.x + r.dy * mv.y + r.dz * mv.z;
    float dw = r.dx * mw.x + r.dy * mw.y + r.dz * mw.z;
    t = -ow / dw;
    u = ou + t * du;
    v = ov + t * dv;
    return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 1e-6f);
}

// Per-ray constants of the precise test (_ray_setup).
struct Shear {
    int kx, ky, kz;
    float sx, sy, sz, opx, opy, opz;
};

__device__ __forceinline__ float pick3(int k, float x, float y, float z) {
    return k == 0 ? x : (k == 1 ? y : z);
}

__device__ __forceinline__ Shear ray_setup(const Ray& r) {
    Shear s;
    float adx = fabsf(r.dx), ady = fabsf(r.dy), adz = fabsf(r.dz);
    s.kz = adx > ady ? (adx >= adz ? 0 : 2) : (ady >= adz ? 1 : 2);
    s.kx = (s.kz + 1) % 3;
    s.ky = (s.kz + 2) % 3;
    float dpz = pick3(s.kz, r.dx, r.dy, r.dz);
    s.sx = -pick3(s.kx, r.dx, r.dy, r.dz) / dpz;
    s.sy = -pick3(s.ky, r.dx, r.dy, r.dz) / dpz;
    s.sz = 1.0f / dpz;
    s.opx = pick3(s.kx, r.ox, r.oy, r.oz);
    s.opy = pick3(s.ky, r.ox, r.oy, r.oz);
    s.opz = pick3(s.kz, r.ox, r.oy, r.oz);
    return s;
}

// Error-free product: p = fl(x y), err = x y - p (Dekker split 2^12 + 1).
__device__ __forceinline__ void two_prod(float x, float y, float& p, float& err) {
    p = x * y;
    float xs = 4097.0f * x;
    float x_hi = xs - (xs - x);
    float x_lo = x - x_hi;
    float ys = 4097.0f * y;
    float y_hi = ys - (ys - y);
    float y_lo = y - y_hi;
    err = ((x_hi * y_hi - p) + x_hi * y_lo + x_lo * y_hi) + x_lo * y_lo;
}

// a b - c d with an exact sign.
__device__ __forceinline__ float diff_of_products(float a, float b, float c, float d) {
    float p, pe, q, qe;
    two_prod(a, b, p, pe);
    two_prod(c, d, q, qe);
    return (p - q) + (pe - qe);
}

// Watertight shear test of triangle `tri` (a 9-float row of tri9); u, v are
// the barycentric weights of p1, p2.
__device__ __forceinline__ bool tri_test_precise(const float* __restrict__ tri9,
                                                 int tri, const Shear& s,
                                                 float tmax, float& t, float& u,
                                                 float& v) {
    const float* row = tri9 + 9 * (size_t)tri;
    float px[3], py[3], pz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float vx = __ldg(row + 3 * k + s.kx) - s.opx;
        float vy = __ldg(row + 3 * k + s.ky) - s.opy;
        float vz = __ldg(row + 3 * k + s.kz) - s.opz;
        px[k] = vx + s.sx * vz;
        py[k] = vy + s.sy * vz;
        pz[k] = s.sz * vz;
    }
    float e0 = diff_of_products(px[1], py[2], py[1], px[2]);
    float e1 = diff_of_products(px[2], py[0], py[2], px[0]);
    float e2 = diff_of_products(px[0], py[1], py[0], px[1]);
    bool same_side = (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f) ||
                     (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f);
    float det = e0 + e1 + e2;
    bool det_ok = det != 0.0f;
    float t_scaled = e0 * pz[0] + e1 * pz[1] + e2 * pz[2];
    float bound = tmax * det;
    bool t_ok = det < 0.0f ? (t_scaled <= 0.0f && t_scaled > bound)
                           : (t_scaled >= 0.0f && t_scaled < bound);
    float inv_det = det_ok ? 1.0f / det : 0.0f;
    t = t_scaled * inv_det;
    u = e1 * inv_det;
    v = e2 * inv_det;
    return same_side && det_ok && t_ok && (t > 1e-6f);
}

// Walk the BVH for one ray.  ANY: stop at the first hit below t_max.
// PRECISE: `tris` is tri9 and the hit test is the watertight shear test;
// else `tris` is tri_m12 and it is the unit-triangle test.
template <bool ANY, bool PRECISE = false>
__device__ __forceinline__ void walk(const float* __restrict__ nodes_f,
                                     const int* __restrict__ nodes_i,
                                     const float* __restrict__ tris,
                                     int n_tri, const Ray& r, float& best_t,
                                     int& best_tri, float& best_u,
                                     float& best_v, unsigned& visits,
                                     unsigned& tests) {
    float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    Shear sh;
    if constexpr (PRECISE) sh = ray_setup(r);
    int stack[MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;  // ref 0 is the root (a pseudo-root for a one-leaf tree)
    while (sp > 0) {
        int ref = stack[--sp];
        if (ref < 0) {
            int payload = -(ref + 1);
            int start = payload >> 3;
            int cnt = payload & 7;
            for (int k = 0; k < cnt; ++k) {
                int tri = start + k;
                if (tri >= n_tri) break;
                ++tests;
                float t, u, v;
                bool better;
                if constexpr (PRECISE) {
                    // the bound test inside is against the ray's t_max; the
                    // first hit is kept whatever its t (that test can pass
                    // a t that rounds to just above t_max)
                    if (!tri_test_precise(tris, tri, sh, r.tmax, t, u, v)) continue;
                    better = ANY || best_tri < 0 || t < best_t ||
                             (t == best_t && tri < best_tri);
                } else {
                    if (!tri_test(tris, tri, r, t, u, v)) continue;
                    better = ANY ? t < r.tmax
                                 : (t < best_t || (t == best_t && tri < best_tri));
                }
                if (!better) continue;
                best_tri = tri;
                if (ANY) return;
                best_t = t;
                best_u = u;
                best_v = v;
            }
            continue;
        }
        ++visits;
        const float4* nf = reinterpret_cast<const float4*>(nodes_f + 12 * (size_t)ref);
        float4 a = __ldg(nf), b = __ldg(nf + 1), c = __ldg(nf + 2);
        int2 ch = __ldg(reinterpret_cast<const int2*>(nodes_i) + ref);
        float t_lim = ANY ? r.tmax : best_t;
        float tl, tr;
        // row layout: [c0.min(3) c0.max(3) c1.min(3) c1.max(3)]
        bool hl = box_hit(a.x, a.y, a.z, a.w, b.x, b.y, r, ix, iy, iz, t_lim, tl);
        bool hr = box_hit(b.z, b.w, c.x, c.y, c.z, c.w, r, ix, iy, iz, t_lim, tr);
        if (hl && hr) {
            bool left_near = tl <= tr;
            stack[sp++] = left_near ? ch.y : ch.x;  // far child first
            stack[sp++] = left_near ? ch.x : ch.y;  // near child on top
        } else if (hl) {
            stack[sp++] = ch.x;
        } else if (hr) {
            stack[sp++] = ch.y;
        }
    }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
closest_hit_kernel(int n, const float* __restrict__ rays,
                   const float* __restrict__ nodes_f,
                   const int* __restrict__ nodes_i,
                   const float* __restrict__ tri_m12, int n_tri,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ b1_out, float* __restrict__ b2_out,
                   bool* __restrict__ hit_out,
                   unsigned long long* __restrict__ counters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r = load_ray(rays, n, i);
    float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1;
    unsigned visits = 0, tests = 0;
    if (r.tmax > 0.0f) {  // t_max <= 0: dead ray
        walk<false>(nodes_f, nodes_i, tri_m12, n_tri, r, best_t, best_tri,
                    best_u, best_v, visits, tests);
    }
    bool hit = best_tri >= 0;
    t_out[i] = hit ? best_t : 3.0e38f;
    tri_out[i] = best_tri;
    b1_out[i] = hit ? best_u : 0.0f;
    b2_out[i] = hit ? best_v : 0.0f;
    hit_out[i] = hit;
    if (counters != nullptr) {
        atomicAdd(counters, (unsigned long long)visits);
        atomicAdd(counters + 1, (unsigned long long)tests);
    }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
any_hit_kernel(int n, const float* __restrict__ rays,
               const float* __restrict__ nodes_f,
               const int* __restrict__ nodes_i,
               const float* __restrict__ tri_m12, int n_tri,
               bool* __restrict__ occ_out,
               unsigned long long* __restrict__ counters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r = load_ray(rays, n, i);
    float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1;
    unsigned visits = 0, tests = 0;
    if (r.tmax >= 0.0f) {  // t_max < 0: inactive ray, reports false
        walk<true>(nodes_f, nodes_i, tri_m12, n_tri, r, best_t, best_tri,
                   best_u, best_v, visits, tests);
    }
    occ_out[i] = best_tri >= 0;
    if (counters != nullptr) {
        atomicAdd(counters, (unsigned long long)visits);
        atomicAdd(counters + 1, (unsigned long long)tests);
    }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
closest_hit_precise_kernel(int n, const float* __restrict__ rays,
                           const float* __restrict__ nodes_f,
                           const int* __restrict__ nodes_i,
                           const float* __restrict__ tri9, int n_tri,
                           float* __restrict__ t_out, int* __restrict__ tri_out,
                           float* __restrict__ b1_out, float* __restrict__ b2_out,
                           bool* __restrict__ hit_out,
                           unsigned long long* __restrict__ counters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r = load_ray(rays, n, i);
    float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1;
    unsigned visits = 0, tests = 0;
    if (r.tmax > 0.0f) {  // t_max <= 0: dead ray
        walk<false, true>(nodes_f, nodes_i, tri9, n_tri, r, best_t, best_tri,
                          best_u, best_v, visits, tests);
    }
    bool hit = best_tri >= 0;
    t_out[i] = hit ? best_t : 3.0e38f;
    tri_out[i] = best_tri;
    b1_out[i] = hit ? best_u : 0.0f;
    b2_out[i] = hit ? best_v : 0.0f;
    hit_out[i] = hit;
    if (counters != nullptr) {
        atomicAdd(counters, (unsigned long long)visits);
        atomicAdd(counters + 1, (unsigned long long)tests);
    }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
any_hit_precise_kernel(int n, const float* __restrict__ rays,
                       const float* __restrict__ nodes_f,
                       const int* __restrict__ nodes_i,
                       const float* __restrict__ tri9, int n_tri,
                       bool* __restrict__ occ_out,
                       unsigned long long* __restrict__ counters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r = load_ray(rays, n, i);
    float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1;
    unsigned visits = 0, tests = 0;
    if (r.tmax >= 0.0f) {  // t_max < 0: inactive ray, reports false
        walk<true, true>(nodes_f, nodes_i, tri9, n_tri, r, best_t, best_tri,
                         best_u, best_v, visits, tests);
    }
    occ_out[i] = best_tri >= 0;
    if (counters != nullptr) {
        atomicAdd(counters, (unsigned long long)visits);
        atomicAdd(counters + 1, (unsigned long long)tests);
    }
}

static inline dim3 grid_for(int n) {
    return dim3((unsigned)((n + BLOCK_THREADS - 1) / BLOCK_THREADS));
}

// Launchers: plain C interface for ctypes.  Each returns cudaGetLastError()
// right after its launch (0 = cudaSuccess); they allocate nothing and do
// not synchronise.
extern "C" int launch_closest_hit(int n, const void* rays, const void* nodes_f,
                                  const void* nodes_i, const void* tri_m12,
                                  int n_tri, void* t_out, void* tri_out,
                                  void* b1_out, void* b2_out, void* hit_out,
                                  void* counters, void* stream) {
    if (n > 0) {
        closest_hit_kernel<<<grid_for(n), BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
            n, (const float*)rays, (const float*)nodes_f, (const int*)nodes_i,
            (const float*)tri_m12, n_tri, (float*)t_out, (int*)tri_out,
            (float*)b1_out, (float*)b2_out, (bool*)hit_out,
            (unsigned long long*)counters);
    }
    return (int)cudaGetLastError();
}

extern "C" int launch_any_hit(int n, const void* rays, const void* nodes_f,
                              const void* nodes_i, const void* tri_m12,
                              int n_tri, void* occ_out, void* counters,
                              void* stream) {
    if (n > 0) {
        any_hit_kernel<<<grid_for(n), BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
            n, (const float*)rays, (const float*)nodes_f, (const int*)nodes_i,
            (const float*)tri_m12, n_tri, (bool*)occ_out,
            (unsigned long long*)counters);
    }
    return (int)cudaGetLastError();
}

extern "C" int launch_closest_hit_precise(int n, const void* rays,
                                          const void* nodes_f,
                                          const void* nodes_i, const void* tri9,
                                          int n_tri, void* t_out, void* tri_out,
                                          void* b1_out, void* b2_out,
                                          void* hit_out, void* counters,
                                          void* stream) {
    if (n > 0) {
        closest_hit_precise_kernel<<<grid_for(n), BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
            n, (const float*)rays, (const float*)nodes_f, (const int*)nodes_i,
            (const float*)tri9, n_tri, (float*)t_out, (int*)tri_out,
            (float*)b1_out, (float*)b2_out, (bool*)hit_out,
            (unsigned long long*)counters);
    }
    return (int)cudaGetLastError();
}

extern "C" int launch_any_hit_precise(int n, const void* rays,
                                      const void* nodes_f, const void* nodes_i,
                                      const void* tri9, int n_tri,
                                      void* occ_out, void* counters,
                                      void* stream) {
    if (n > 0) {
        any_hit_precise_kernel<<<grid_for(n), BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
            n, (const float*)rays, (const float*)nodes_f, (const int*)nodes_i,
            (const float*)tri9, n_tri, (bool*)occ_out,
            (unsigned long long*)counters);
    }
    return (int)cudaGetLastError();
}

extern "C" int trace_kernels_max_stack() { return MAX_STACK; }
