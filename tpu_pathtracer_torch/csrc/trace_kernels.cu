// Ray traversal kernels for Hopper (sm_90a): closest hit (K1) and any hit (K2).
//
// Replace the TPU kernels of tpu_pathtracer/ops/pallas_trace.py:
//   closest_hit_kernel <- _kernel_closest_fast (with _block_test_fast and
//                         the packed-key decode in traverse)
//   any_hit_kernel     <- _kernel_anyhit (its fast, precise=False form)
//
// Design.  The TPU kernels test every ray of a 64-ray subtile against
// dense 128-triangle blocks held in VMEM, because TPU gathers run as a
// scalar loop.  On Hopper a gather is an ordinary load, so each thread
// walks the flat BVH for one ray: pop a node ref from a per-thread stack,
// test both child boxes of an internal node (rows of nodes_f / nodes_i)
// and push the hit children far-first, or test the <= 7 triangles of an
// inline leaf against their unit-triangle transform rows (tri_m12).
//
// Hit test (the same arithmetic as the plain PyTorch version in
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

// Walk the BVH for one ray.  ANY: stop at the first hit below t_max.
template <bool ANY>
__device__ __forceinline__ void walk(const float* __restrict__ nodes_f,
                                     const int* __restrict__ nodes_i,
                                     const float* __restrict__ tri_m12,
                                     int n_tri, const Ray& r, float& best_t,
                                     int& best_tri, float& best_u,
                                     float& best_v, unsigned& visits,
                                     unsigned& tests) {
    float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
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
                if (!tri_test(tri_m12, tri, r, t, u, v)) continue;
                if (ANY) {
                    if (t < r.tmax) {
                        best_tri = tri;
                        return;
                    }
                } else if (t < best_t || (t == best_t && tri < best_tri)) {
                    best_t = t;
                    best_tri = tri;
                    best_u = u;
                    best_v = v;
                }
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

extern "C" int trace_kernels_max_stack() { return MAX_STACK; }
