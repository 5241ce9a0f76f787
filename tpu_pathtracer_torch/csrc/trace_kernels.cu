// Ray traversal kernels for Hopper (sm_90a): closest hit and any hit, each
// with the fast unit-triangle test (K1, K2) and with the precise watertight
// shear test (K3, K2p).
//
// Replace the TPU kernels of tpu_pathtracer/ops/pallas_trace.py:
//   closest_hit_team_kernel<false> <- _kernel_closest_fast (with
//                                 _block_test_fast and the packed-key decode
//                                 in traverse)
//   any_hit_kernel<false>      <- _kernel_anyhit (its fast, precise=False form)
//   closest_hit_team_kernel<true> <- _kernel_closest (with _ray_setup,
//                                 _block_test and _diff_of_products)
//   any_hit_kernel<true>       <- _kernel_anyhit (its precise=True form)
//
// The TPU kernels test every ray of a 64-ray subtile against dense
// 128-triangle blocks held in VMEM, because TPU gathers run as a scalar
// loop.  On Hopper a gather is an ordinary load, so the kernels walk a BVH:
// the any-hit kernels one thread a ray, the closest-hit kernels a warp of
// lanes that share their rays' work.
//
// What bounds the walk (measured on an H100; the readings are in PERF.md).
// Per ray the work is small and data-dependent (a handful of node visits
// and triangle tests) and the tables (about 1 MB) stay in L2, so neither
// the bytes nor the arithmetic of a launch take long.  What takes long is
// the chain and its company: every step of a ray waits for the load of the
// node or triangle the step before chose and for the dependent arithmetic
// of its test, a few hundred ns a step, so the longest ray of a launch
// alone lasts a third to a half of it (a launch of its first 1/32 of the
// rays takes that long); and the rays of a warp visit nodes, test leaves
// and end at different times, so a warp of independent threads lasts as
// long as its longest ray while most of its lanes idle, and the card holds
// the launch in about two rounds of such warps.  The closest-hit kernels
// (K1, K3) shorten the chain and fill the lanes:
//   - 4-wide nodes, one 128-byte line each (nodes_w of ops/trace.py
//     widen_bvh: [lo_x(4) lo_y(4) lo_z(4) hi_x(4) hi_y(4) hi_z(4) ref(4)
//     pad(4)], rows in breadth-first order).  A visit makes seven
//     independent 16-byte loads of one line, tests four boxes and descends
//     up to two binary levels: about half the links.  (A wide visit costs
//     about twice the arithmetic of a binary one, so the gain is in the
//     chain, not in the throughput.)
//   - The hit children are sorted by entry distance (a five-exchange
//     network); the nearest is visited next straight from its register,
//     the others are pushed far-first with their entry distance, and a
//     popped entry whose distance no longer passes the cull is dropped
//     without loading its node.  The stack is the thread's own (local
//     memory): with the near child in a register a pop is off the chain.
//   - One load stream: a lane at a node and a lane at a leaf make the same
//     seven loads, each from its own row, before either computes, so a
//     warp with lanes of both kinds waits for memory once a step and not
//     once for each kind.  A leaf lane's loads are its next two triangles:
//     a leaf's triangles (at most 4 from build_bvh, MAX_LEAF_SIZE; the
//     3-bit payload could name 7) are read two at a time before the first
//     is tested, three 16-byte loads each (K1 tests both in the step, K3
//     one); the precise kernel reads tri9p ([x0 x1 x2 0 | y0 y1 y2 0 |
//     z0 z1 z2 0]), whose groups it loads in the order of the ray's axis
//     permutation, in place of nine scalar loads.
//   - A warp is a team: its lanes run in lockstep, one step of the load
//     stream a turn.  The warp owns a slice of the rays; when
//     TEAM_REFILL_MIN lanes are idle they take the slice's next rays, so a
//     lane does not idle while its warp's longest ray ends; when the slice
//     is used up and TEAM_STEAL_MIN lanes are idle, each takes the top
//     stack entry (the nearest pending subtree) of a lane that has one,
//     with a copy of its ray and best hit, so a long ray is walked by many
//     lanes.  The lanes on one ray agree every turn on the nearest of
//     their hits, the lower triangle id on a tie (match_any, reduce_min,
//     shuffles), which is also their cull bound; a lane whose part is done
//     falls idle and the last one stores the result.  Only as many blocks
//     run as the card holds at once.
// No shared memory is used.  Built, measured and removed again because they
// did not pay on this card (PERF.md has each one's time): the stack in
// shared memory (it costs occupancy); resident blocks whose threads take
// ray after ray from a counter; the top rows of the tree in shared memory
// (a row that many lanes share is one L1 transaction already); and a
// leaf's four triangles loaded at once (registers, hence occupancy).  Any
// conservative cull gives the same answers whatever the visit order, and
// the nearest hit of a ray is the nearest of its parts' nearest hits, so
// the results are those of the brute-force plain versions bit for bit.
//
// The any-hit kernels (K2, K2p) keep the binary walk: pop a node ref from a
// per-thread stack, test both child boxes of an internal node (rows of
// nodes_f / nodes_i), push the hit children far-first, or test the
// triangles of an inline leaf.  closest_hit_v1_kernel is the closest-hit
// form of that walk, kept as the yardstick the wide kernels are timed
// against; no render path launches it.
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
// exact tie.  The axis permutation is folded into the load address (K2p:
// row[3 v + k] of tri9, whose 36-byte rows are not 16-byte aligned, so nine
// scalar __ldg loads; K3: group k of tri9p).  The box cull keeps the padded
// far distance and T_SLACK: the precise t is tight, but a triangle lying in
// a box face can still lose its box to slab rounding.
//
// With `counters` given, each thread adds its node visits and triangle
// tests to counters[0] and counters[1]; the closest-hit kernels also keep
// the largest count of any single ray in counters[2] and counters[3].
// From these a caller computes the least operation count of the call and
// reads how long the longest chain was.
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#define MAX_STACK 64    // must match cuda_trace.MAX_STACK
#define BLOCK_THREADS 128
#define T_SLACK 1.001f  // relative slack of the box cull against t_lim

// The team's thresholds, both chosen by measurement on an H100.
#define TEAM_REFILL_MIN 8  // idle lanes before a warp takes new rays
#define TEAM_STEAL_MIN 12  // idle lanes before they take others' stack entries
#define WIDE_MAX_STACK 64  // must match cuda_trace.WIDE_MAX_STACK
#define WIDE_DONE INT_MIN  // no leaf ref: payloads stay below 2^31 - 1

typedef unsigned long long u64;

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

// Unit-triangle transform test; mu, mv, mw are the three 4-float groups of
// the triangle's row of tri_m12.
__device__ __forceinline__ bool tri_test(float4 mu, float4 mv, float4 mw,
                                         const Ray& r, float& t, float& u,
                                         float& v) {
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

// Watertight shear test of one triangle; ax, ay, az hold the three
// vertices' coordinates on the ray's kx, ky and kz axes; u, v are the
// barycentric weights of p1, p2.
__device__ __forceinline__ bool tri_test_precise(const float ax[3],
                                                 const float ay[3],
                                                 const float az[3],
                                                 const Shear& s, float tmax,
                                                 float& t, float& u, float& v) {
    float px[3], py[3], pz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float vx = ax[k] - s.opx;
        float vy = ay[k] - s.opy;
        float vz = az[k] - s.opz;
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

// Whether a hit at t of triangle `tri` replaces the best so far.  Fast
// test: below the bound (the ray's t_max until a hit is kept), the lower
// id on an exact tie.  Precise test: its bound test against the ray's
// t_max is inside the test and can pass a t that rounds to just above
// t_max, so the first hit is kept whatever its t.
template <bool PRECISE>
__device__ __forceinline__ bool closer(float t, int tri, float best_t,
                                       int best_tri) {
    bool lower = t < best_t || (t == best_t && tri < best_tri);
    return PRECISE ? (best_tri < 0 || lower) : lower;
}

// Walk the binary BVH for one ray.  ANY: stop at the first hit below t_max.
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
                    const float* row = tris + 9 * (size_t)tri;
                    float ax[3], ay[3], az[3];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        ax[c] = __ldg(row + 3 * c + sh.kx);
                        ay[c] = __ldg(row + 3 * c + sh.ky);
                        az[c] = __ldg(row + 3 * c + sh.kz);
                    }
                    if (!tri_test_precise(ax, ay, az, sh, r.tmax, t, u, v))
                        continue;
                    better = ANY || closer<true>(t, tri, best_t, best_tri);
                } else {
                    const float4* row =
                        reinterpret_cast<const float4*>(tris + 12 * (size_t)tri);
                    if (!tri_test(__ldg(row), __ldg(row + 1), __ldg(row + 2), r,
                                  t, u, v))
                        continue;
                    better = ANY ? t < r.tmax
                                 : closer<false>(t, tri, best_t, best_tri);
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

// The state of one ray's walk of the wide tree.
struct Lane {
    Ray r;
    float ix, iy, iz;      // 1 / direction
    Shear sh;              // PRECISE only
    int g0, g1, g2;        // a triangle row's groups in the order they are read
    float best_t, best_u, best_v;
    int best_tri;
    float lim;             // the cull bound: the nearest hit so far, or t_max
    int i;                 // the ray's index, < 0 for an idle lane
    int cur;               // the ref to visit next, WIDE_DONE when none is left
    int tri, leaf_end;     // cur a leaf: its triangles left
    int sp;                // entries on the lane's stack
    unsigned visits, tests;
};

// Make ray i the lane's ray.  Its t_max is read first: of a dead ray
// (t_max <= 0) nothing else is read or computed, and L.cur is WIDE_DONE.
template <bool PRECISE>
__device__ __forceinline__ void start_ray(Lane& L, const float* __restrict__ rays,
                                          int n, int i) {
    L.i = i;
    L.r.tmax = rays[6 * n + i];
    L.best_t = L.r.tmax, L.best_u = 0.0f, L.best_v = 0.0f;
    L.best_tri = -1;
    L.lim = L.r.tmax;
    L.sp = 0;
    L.visits = 0, L.tests = 0;
    L.cur = WIDE_DONE;
    if (!(L.r.tmax > 0.0f)) return;
    L.r = load_ray(rays, n, i);
    L.ix = 1.0f / L.r.dx, L.iy = 1.0f / L.r.dy, L.iz = 1.0f / L.r.dz;
    L.g0 = 0, L.g1 = 1, L.g2 = 2;
    if constexpr (PRECISE) {
        L.sh = ray_setup(L.r);
        L.g0 = L.sh.kx, L.g1 = L.sh.ky, L.g2 = L.sh.kz;
    }
    L.cur = 0;  // row 0 is the root (of a one-leaf tree too)
}

__device__ __forceinline__ void push(Lane& L, u64* stack, int ref, float tn) {
    stack[L.sp++] = ((u64)__float_as_uint(tn) << 32) | (unsigned)ref;
}

// Whether a stack entry's entry distance still passes the cull at `lim`.
__device__ __forceinline__ bool entry_passes(u64 e, float lim) {
    return __uint_as_float((unsigned)(e >> 32)) <= lim * T_SLACK;
}

// The next ref of the lane's stack that still passes the cull, or WIDE_DONE.
__device__ __forceinline__ int pop(Lane& L, const u64* stack) {
    while (L.sp > 0) {
        u64 e = stack[--L.sp];
        if (entry_passes(e, L.lim)) return (int)(unsigned)e;
    }
    return WIDE_DONE;
}

// One child of a wide node: its slab test; a miss gets an infinite entry
// distance, a hit one clamped to >= 0 (the order of the children and the
// cull of a popped entry need no more).
#define WIDE_CHILD(k, c)                                                     \
    {                                                                        \
        float tn;                                                            \
        bool h = box_hit(lox.c, loy.c, loz.c, hix.c, hiy.c, hiz.c, L.r, L.ix, \
                         L.iy, L.iz, L.lim, tn);                             \
        t[k] = h ? fmaxf(tn, 0.0f) : CUDART_INF_F;                           \
        ref[k] = __float_as_int(refs.c);                                     \
    }
#define WIDE_ORDER(a, b)                           \
    {                                              \
        bool s = t[b] < t[a];                      \
        float ta = t[a], tb = t[b];                \
        int ra = ref[a], rb = ref[b];              \
        t[a] = s ? tb : ta;                        \
        t[b] = s ? ta : tb;                        \
        ref[a] = s ? rb : ra;                      \
        ref[b] = s ? ra : rb;                      \
    }

// Test the four child boxes of a wide node's row and return the nearest hit
// child, the others pushed far-first (WIDE_DONE or a popped entry when no
// child is hit).
__device__ __forceinline__ int visit(Lane& L, float4 lox, float4 loy, float4 loz,
                                     float4 hix, float4 hiy, float4 hiz,
                                     float4 refs, u64* stack) {
    ++L.visits;
    float t[4];
    int ref[4];
    WIDE_CHILD(0, x) WIDE_CHILD(1, y) WIDE_CHILD(2, z) WIDE_CHILD(3, w)
    WIDE_ORDER(0, 1) WIDE_ORDER(2, 3) WIDE_ORDER(0, 2) WIDE_ORDER(1, 3)
    WIDE_ORDER(1, 2)
    // the hits now come first, nearest first; far ones go down first
    if (t[3] < CUDART_INF_F) push(L, stack, ref[3], t[3]);
    if (t[2] < CUDART_INF_F) push(L, stack, ref[2], t[2]);
    if (t[1] < CUDART_INF_F) push(L, stack, ref[1], t[1]);
    return t[0] < CUDART_INF_F ? ref[0] : pop(L, stack);
}

// Test triangle `tri`, whose row's three groups are a, b, c in the lane's
// order, and keep it if it is the better hit.
template <bool PRECISE>
__device__ __forceinline__ void test(Lane& L, int tri, float4 a, float4 b,
                                     float4 c) {
    ++L.tests;
    float t, u, v;
    bool hit;
    if constexpr (PRECISE) {
        float ax[3] = {a.x, a.y, a.z};
        float ay[3] = {b.x, b.y, b.z};
        float az[3] = {c.x, c.y, c.z};
        hit = tri_test_precise(ax, ay, az, L.sh, L.r.tmax, t, u, v);
    } else {
        hit = tri_test(a, b, c, L.r, t, u, v);
    }
    if (hit && closer<PRECISE>(t, tri, L.best_t, L.best_tri)) {
        L.best_tri = tri;
        L.best_t = t;
        L.best_u = u;
        L.best_v = v;
        L.lim = fminf(L.lim, t);
    }
}

// Make `ref` the lane's current ref; a leaf's triangle range is unpacked
// and an empty leaf skipped.
__device__ __forceinline__ void enter(Lane& L, int ref, int n_tri,
                                      const u64* stack) {
    for (;;) {
        L.cur = ref;
        if (ref >= 0 || ref == WIDE_DONE) return;
        int payload = -(ref + 1);
        L.tri = payload >> 3;
        L.leaf_end = min(L.tri + (payload & 7), n_tri);
        if (L.tri < L.leaf_end) return;
        ref = pop(L, stack);
    }
}

// One step of the walk, in which a lane at a node and a lane at a leaf make
// the same seven loads, each from its own row (a node's row, or the rows of
// the leaf's next two triangles), before either computes: a warp whose
// lanes are at nodes and at leaves then waits for memory once a step, not
// once for each kind.  `tris` is tri_m12 or, PRECISE, tri9p: three 16-byte
// groups a row.
template <bool PRECISE>
__device__ __forceinline__ void step(Lane& L, const float4* nodes_w,
                                     const float4* tris, int n_tri,
                                     u64* stack) {
    const bool at_node = L.cur >= 0;
    const float4* p0;
    const float4* p1;
    int o0 = 0, o1 = 1, o2 = 2, o6 = 6;
    if (at_node) {
        p0 = nodes_w + 8 * (size_t)L.cur;
        p1 = p0 + 3;
    } else {
        p0 = tris + 3 * (size_t)L.tri;
        p1 = tris + 3 * (size_t)min(L.tri + 1, L.leaf_end - 1);
        o0 = L.g0, o1 = L.g1, o2 = L.g2, o6 = 0;
    }
    float4 a0 = p0[o0], a1 = p0[o1], a2 = p0[o2];
    float4 a3 = p1[o0], a4 = p1[o1], a5 = p1[o2];
    float4 a6 = p0[o6];
    if (at_node) {
        enter(L, visit(L, a0, a1, a2, a3, a4, a5, a6, stack), n_tri, stack);
    } else {
        // two fast tests a step; one precise test, which is four times the
        // arithmetic: a second one for the few lanes that have a second
        // triangle costs the whole warp more than it saves them (measured)
        constexpr int tests_a_step = PRECISE ? 1 : 2;
        test<PRECISE>(L, L.tri, a0, a1, a2);
        if (tests_a_step > 1 && L.tri + 1 < L.leaf_end)
            test<PRECISE>(L, L.tri + 1, a3, a4, a5);
        L.tri += tests_a_step;
        if (L.tri >= L.leaf_end) enter(L, pop(L, stack), n_tri, stack);
    }
}

__device__ __forceinline__ void store_closest(
    int i, float best_t, int best_tri, float best_u, float best_v,
    unsigned visits, unsigned tests, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ b1_out,
    float* __restrict__ b2_out, bool* __restrict__ hit_out,
    u64* __restrict__ counters) {
    bool hit = best_tri >= 0;
    t_out[i] = hit ? best_t : 3.0e38f;
    tri_out[i] = best_tri;
    b1_out[i] = hit ? best_u : 0.0f;
    b2_out[i] = hit ? best_v : 0.0f;
    hit_out[i] = hit;
    if (counters != nullptr) {
        atomicAdd(counters, (u64)visits);
        atomicAdd(counters + 1, (u64)tests);
        atomicMax(counters + 2, (u64)visits);
        atomicMax(counters + 3, (u64)tests);
    }
}

// K1 (PRECISE = false, tris = tri_m12) and K3 (PRECISE = true, tris =
// tri9p): the lanes of a warp run in lockstep, one step a turn, and share
// the warp's work.  A warp
// owns a slice of the rays; idle lanes take its next rays while there are
// any, and after that the top stack entry (the nearest pending subtree) of
// a lane that has one, with a copy of its ray and of its best hit, so that
// a long ray is walked by many lanes.  The lanes on one ray agree on the
// nearest of their hits every turn (which is also their cull bound); a lane
// whose part is done falls idle, and the last one stores the result.
template <bool PRECISE>
__global__ void __launch_bounds__(BLOCK_THREADS)
closest_hit_team_kernel(int n, const float* __restrict__ rays,
                        const float4* __restrict__ nodes_w,
                        const float4* __restrict__ tris, int n_tri,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ b1_out, float* __restrict__ b2_out,
                        bool* __restrict__ hit_out, u64* __restrict__ counters) {
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1;
    const long long warps = (long long)gridDim.x * (BLOCK_THREADS / 32);
    const long long warp = (long long)blockIdx.x * (BLOCK_THREADS / 32) + (threadIdx.x >> 5);
    const long long slice = (n + warps - 1) / warps;
    int next = (int)min((long long)n, slice * warp);
    const int end = (int)min((long long)n, next + slice);
    u64 stack[WIDE_MAX_STACK];
    Lane L;
    L.i = -1;
    L.cur = WIDE_DONE;
    L.sp = 0;
    L.best_tri = -1;
    L.best_t = 0.0f, L.best_u = 0.0f, L.best_v = 0.0f, L.lim = 0.0f;
    L.visits = 0, L.tests = 0;
    bool sharing = false;  // a ray of this warp is walked by several lanes
    for (;;) {
        unsigned idle = __ballot_sync(all, L.i < 0);
        if (next < end && (__popc(idle) >= TEAM_REFILL_MIN || idle == all)) {
            int take = min(__popc(idle), end - next);
            int rank = __popc(idle & below);
            if (L.i < 0 && rank < take) {
                start_ray<PRECISE>(L, rays, n, next + rank);
                if (L.cur == WIDE_DONE) {  // a dead ray: a miss, at once
                    store_closest(L.i, L.best_t, -1, 0.0f, 0.0f, 0, 0, t_out,
                                  tri_out, b1_out, b2_out, hit_out, counters);
                    L.i = -1;
                }
            }
            next += take;
            idle = __ballot_sync(all, L.i < 0);
        }
        if (idle == all) {
            if (next >= end) break;
            continue;
        }
        unsigned donors = __ballot_sync(all, L.i >= 0 && L.sp > 0);
        if (next >= end && donors != 0 && __popc(idle) >= TEAM_STEAL_MIN) {
            sharing = true;
            int pairs = min(__popc(idle), __popc(donors));
            bool takes = L.i < 0 && __popc(idle & below) < pairs;
            bool gives = L.i >= 0 && L.sp > 0 && __popc(donors & below) < pairs;
            int src = takes ? (int)__fns(donors, 0, __popc(idle & below) + 1) : lane;
            u64 entry = 0;
            if (gives) entry = stack[--L.sp];
            entry = __shfl_sync(all, entry, src);
            Ray r;
            r.ox = __shfl_sync(all, L.r.ox, src);
            r.oy = __shfl_sync(all, L.r.oy, src);
            r.oz = __shfl_sync(all, L.r.oz, src);
            r.dx = __shfl_sync(all, L.r.dx, src);
            r.dy = __shfl_sync(all, L.r.dy, src);
            r.dz = __shfl_sync(all, L.r.dz, src);
            r.tmax = __shfl_sync(all, L.r.tmax, src);
            float best_t = __shfl_sync(all, L.best_t, src);
            float best_u = __shfl_sync(all, L.best_u, src);
            float best_v = __shfl_sync(all, L.best_v, src);
            int best_tri = __shfl_sync(all, L.best_tri, src);
            float lim = __shfl_sync(all, L.lim, src);
            int i = __shfl_sync(all, L.i, src);
            // the ray's derived constants come with it: a shuffle is
            // cheaper than the divisions that made them
            float ix = __shfl_sync(all, L.ix, src);
            float iy = __shfl_sync(all, L.iy, src);
            float iz = __shfl_sync(all, L.iz, src);
            Shear sh;
            if constexpr (PRECISE) {
                sh.kz = __shfl_sync(all, L.sh.kz, src);
                sh.kx = (sh.kz + 1) % 3;
                sh.ky = (sh.kz + 2) % 3;
                sh.sx = __shfl_sync(all, L.sh.sx, src);
                sh.sy = __shfl_sync(all, L.sh.sy, src);
                sh.sz = __shfl_sync(all, L.sh.sz, src);
                sh.opx = pick3(sh.kx, r.ox, r.oy, r.oz);
                sh.opy = pick3(sh.ky, r.ox, r.oy, r.oz);
                sh.opz = pick3(sh.kz, r.ox, r.oy, r.oz);
            }
            if (takes) {
                L.r = r;
                L.ix = ix, L.iy = iy, L.iz = iz;
                L.g0 = 0, L.g1 = 1, L.g2 = 2;
                if constexpr (PRECISE) {
                    L.sh = sh;
                    L.g0 = sh.kx, L.g1 = sh.ky, L.g2 = sh.kz;
                }
                L.best_t = best_t, L.best_u = best_u, L.best_v = best_v;
                L.best_tri = best_tri;
                L.lim = lim;
                L.i = i;
                L.sp = 0;
                L.visits = 0, L.tests = 0;
                enter(L, entry_passes(entry, lim) ? (int)(unsigned)entry : WIDE_DONE,
                      n_tri, stack);
            }
        }
        if (L.i >= 0 && L.cur != WIDE_DONE)
            step<PRECISE>(L, nodes_w, tris, n_tri, stack);
        bool done = L.i >= 0 && L.cur == WIDE_DONE;
        if (!sharing) {
            if (done) {
                store_closest(L.i, L.best_t, L.best_tri, L.best_u, L.best_v,
                              L.visits, L.tests, t_out, tri_out, b1_out,
                              b2_out, hit_out, counters);
                L.i = -1;
            }
            continue;
        }
        // the lanes on one ray agree on the nearest of their hits, the lower
        // triangle id on a tie
        const unsigned no_hit = 0x7f800000u;
        unsigned group = __match_any_sync(all, L.i);
        bool has = L.i >= 0 && L.best_tri >= 0;
        unsigned key = has ? __float_as_uint(L.best_t) : no_hit;
        unsigned nearest = __reduce_min_sync(group, key);
        unsigned tri_key = (has && key == nearest) ? (unsigned)L.best_tri : 0xffffffffu;
        unsigned lowest = __reduce_min_sync(group, tri_key);
        unsigned winners = group & __ballot_sync(all, has && key == nearest &&
                                                          tri_key == lowest);
        int src = winners ? __ffs(winners) - 1 : lane;
        float t = __shfl_sync(all, L.best_t, src);
        float u = __shfl_sync(all, L.best_u, src);
        float v = __shfl_sync(all, L.best_v, src);
        int tri = __shfl_sync(all, L.best_tri, src);
        if (L.i >= 0 && winners) {
            L.best_t = t, L.best_u = u, L.best_v = v;
            L.best_tri = tri;
            L.lim = fminf(L.lim, t);
        }
        // lanes that are done leave; the last lane on a ray stores it
        unsigned busy = group & ~__ballot_sync(all, done);
        int keeper = __ffs(busy ? busy : group) - 1;
        if (counters != nullptr) {
            bool leaves = done && lane != keeper;
            unsigned visits = __reduce_add_sync(group, leaves ? L.visits : 0u);
            unsigned tests = __reduce_add_sync(group, leaves ? L.tests : 0u);
            if (lane == keeper) L.visits += visits, L.tests += tests;
        }
        if (done) {
            if (lane == keeper)
                store_closest(L.i, L.best_t, L.best_tri, L.best_u, L.best_v,
                              L.visits, L.tests, t_out, tri_out, b1_out,
                              b2_out, hit_out, counters);
            L.i = -1;
        }
    }
}

// The binary closest-hit walk the wide kernels replaced (tris = tri_m12 or,
// PRECISE, tri9): the yardstick of their times, on no render path.
template <bool PRECISE>
__global__ void __launch_bounds__(BLOCK_THREADS)
closest_hit_v1_kernel(int n, const float* __restrict__ rays,
                      const float* __restrict__ nodes_f,
                      const int* __restrict__ nodes_i,
                      const float* __restrict__ tris, int n_tri,
                      float* __restrict__ t_out, int* __restrict__ tri_out,
                      float* __restrict__ b1_out, float* __restrict__ b2_out,
                      bool* __restrict__ hit_out, u64* __restrict__ counters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r = load_ray(rays, n, i);
    float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1;
    unsigned visits = 0, tests = 0;
    if (r.tmax > 0.0f) {  // t_max <= 0: dead ray
        walk<false, PRECISE>(nodes_f, nodes_i, tris, n_tri, r, best_t, best_tri,
                             best_u, best_v, visits, tests);
    }
    store_closest(i, best_t, best_tri, best_u, best_v, visits, tests, t_out,
                  tri_out, b1_out, b2_out, hit_out, counters);
}

template <bool PRECISE>
__global__ void __launch_bounds__(BLOCK_THREADS)
any_hit_kernel(int n, const float* __restrict__ rays,
               const float* __restrict__ nodes_f,
               const int* __restrict__ nodes_i,
               const float* __restrict__ tris, int n_tri,
               bool* __restrict__ occ_out, u64* __restrict__ counters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r = load_ray(rays, n, i);
    float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
    int best_tri = -1;
    unsigned visits = 0, tests = 0;
    if (r.tmax >= 0.0f) {  // t_max < 0: inactive ray, reports false
        walk<true, PRECISE>(nodes_f, nodes_i, tris, n_tri, r, best_t, best_tri,
                            best_u, best_v, visits, tests);
    }
    occ_out[i] = best_tri >= 0;
    if (counters != nullptr) {
        atomicAdd(counters, (u64)visits);
        atomicAdd(counters + 1, (u64)tests);
    }
}

static inline dim3 grid_for(int n) {
    return dim3((unsigned)((n + BLOCK_THREADS - 1) / BLOCK_THREADS));
}

// Resident blocks an SM and the grid of a closest-hit launch: as many blocks
// as the card holds at once, at most one a 128 rays.  Returns a CUDA error
// code.
template <bool PRECISE>
static int team_grid(int n, int* blocks_per_sm, int* grid) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, closest_hit_team_kernel<PRECISE>, BLOCK_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    *grid = min((int)grid_for(n).x, sms * *blocks_per_sm);
    return 0;
}

template <bool PRECISE>
static int launch_wide(int n, const void* rays, const void* nodes_w,
                       const void* tris, int n_tri, void* t_out, void* tri_out,
                       void* b1_out, void* b2_out, void* hit_out,
                       void* counters, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    int per_sm, blocks;
    int rc = team_grid<PRECISE>(n, &per_sm, &blocks);
    if (rc != 0) return rc;
    if (blocks <= 0) return (int)cudaErrorLaunchOutOfResources;
    closest_hit_team_kernel<PRECISE>
        <<<blocks, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
            n, (const float*)rays, (const float4*)nodes_w, (const float4*)tris,
            n_tri, (float*)t_out, (int*)tri_out, (float*)b1_out,
            (float*)b2_out, (bool*)hit_out, (u64*)counters);
    return (int)cudaGetLastError();
}

// Launchers: plain C interface for ctypes.  Each returns a CUDA error code
// (0 = cudaSuccess), that of cudaGetLastError() right after its launch;
// they allocate nothing and do not synchronise.
extern "C" int launch_closest_hit(int n, const void* rays, const void* nodes_w,
                                  const void* tri_m12, int n_tri, void* t_out,
                                  void* tri_out, void* b1_out, void* b2_out,
                                  void* hit_out, void* counters,
                                  void* stream) {
    return launch_wide<false>(n, rays, nodes_w, tri_m12, n_tri, t_out, tri_out,
                              b1_out, b2_out, hit_out, counters, stream);
}

extern "C" int launch_closest_hit_precise(int n, const void* rays,
                                          const void* nodes_w,
                                          const void* tri9p, int n_tri,
                                          void* t_out, void* tri_out,
                                          void* b1_out, void* b2_out,
                                          void* hit_out, void* counters,
                                          void* stream) {
    return launch_wide<true>(n, rays, nodes_w, tri9p, n_tri, t_out, tri_out,
                             b1_out, b2_out, hit_out, counters, stream);
}

// What a closest-hit launch of n rays occupies: out = [registers a thread,
// local bytes a thread, resident blocks an SM, grid].  Returns a CUDA error
// code.
extern "C" int closest_hit_launch_info(int precise, int n, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err =
        precise ? cudaFuncGetAttributes(&attr, closest_hit_team_kernel<true>)
                : cudaFuncGetAttributes(&attr, closest_hit_team_kernel<false>);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    return precise ? team_grid<true>(n, out + 2, out + 3)
                   : team_grid<false>(n, out + 2, out + 3);
}

template <bool PRECISE>
static int launch_v1(int n, const void* rays, const void* nodes_f,
                     const void* nodes_i, const void* tris, int n_tri,
                     void* t_out, void* tri_out, void* b1_out, void* b2_out,
                     void* hit_out, void* counters, void* stream) {
    if (n > 0) {
        closest_hit_v1_kernel<PRECISE>
            <<<grid_for(n), BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
                n, (const float*)rays, (const float*)nodes_f,
                (const int*)nodes_i, (const float*)tris, n_tri, (float*)t_out,
                (int*)tri_out, (float*)b1_out, (float*)b2_out, (bool*)hit_out,
                (u64*)counters);
    }
    return (int)cudaGetLastError();
}

extern "C" int launch_closest_hit_v1(int n, const void* rays,
                                     const void* nodes_f, const void* nodes_i,
                                     const void* tri_m12, int n_tri,
                                     void* t_out, void* tri_out, void* b1_out,
                                     void* b2_out, void* hit_out,
                                     void* counters, void* stream) {
    return launch_v1<false>(n, rays, nodes_f, nodes_i, tri_m12, n_tri, t_out,
                            tri_out, b1_out, b2_out, hit_out, counters, stream);
}

extern "C" int launch_closest_hit_precise_v1(int n, const void* rays,
                                             const void* nodes_f,
                                             const void* nodes_i,
                                             const void* tri9, int n_tri,
                                             void* t_out, void* tri_out,
                                             void* b1_out, void* b2_out,
                                             void* hit_out, void* counters,
                                             void* stream) {
    return launch_v1<true>(n, rays, nodes_f, nodes_i, tri9, n_tri, t_out,
                           tri_out, b1_out, b2_out, hit_out, counters, stream);
}

template <bool PRECISE>
static int launch_any(int n, const void* rays, const void* nodes_f,
                      const void* nodes_i, const void* tris, int n_tri,
                      void* occ_out, void* counters, void* stream) {
    if (n > 0) {
        any_hit_kernel<PRECISE>
            <<<grid_for(n), BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
                n, (const float*)rays, (const float*)nodes_f,
                (const int*)nodes_i, (const float*)tris, n_tri, (bool*)occ_out,
                (u64*)counters);
    }
    return (int)cudaGetLastError();
}

extern "C" int launch_any_hit(int n, const void* rays, const void* nodes_f,
                              const void* nodes_i, const void* tri_m12,
                              int n_tri, void* occ_out, void* counters,
                              void* stream) {
    return launch_any<false>(n, rays, nodes_f, nodes_i, tri_m12, n_tri, occ_out,
                             counters, stream);
}

extern "C" int launch_any_hit_precise(int n, const void* rays,
                                      const void* nodes_f, const void* nodes_i,
                                      const void* tri9, int n_tri,
                                      void* occ_out, void* counters,
                                      void* stream) {
    return launch_any<true>(n, rays, nodes_f, nodes_i, tri9, n_tri, occ_out,
                            counters, stream);
}

extern "C" int trace_kernels_max_stack() { return MAX_STACK; }
extern "C" int trace_kernels_wide_max_stack() { return WIDE_MAX_STACK; }
