// The material layer: for every lane, the sample (bsdf_sample_kernel) or
// the value and pdf (bsdf_eval_kernel) of its own BSDF kind, bit for bit
// the torch ops of tpu_pathtracer_torch/render/bsdf.py (sample_material,
// evaluate_material) on an untextured scene.
//
// They replace no TPU kernel: the JAX package's material layer is plain
// jnp, which XLA fuses.  In PyTorch those ops run every kind the scene
// holds over every lane of the tile and merge the results by mat_type
// masks: counted on one wavefront step of the benchmark's scenes, the
// layer dispatched ~2,100 (sample) and ~1,650 (evaluate) elementwise ops
// a step on the dragon scan (Lambert, clearcoat) and ~4,650 and ~3,300 on
// the spheres under the sky (Lambert, PBR, clearcoat, plastic), 79 % and
// 83 % of the step's ops, each a launch that reads and writes every lane.
//
// Design: one thread a lane.  The lane's inputs are read once (each a
// float column with its own stride: structure of arrays, coalesced), its
// material row through the read-only cache, and a switch on its kind runs
// that kind alone, and of a kind only the lobe the lane picks; every
// intermediate stays in registers.  The arithmetic is the torch path's,
// op for op and in its order: the same libm calls (sqrtf, rsqrtf, expf,
// logf, sinf, cosf, atan2f, powf; torch's CUDA kernels call these), torch's
// pow with a scalar exponent (2 -> x * x), clamp and where with their NaN
// rules, a python float rounded to float32 where torch rounds it, and no
// contraction into FMA (the build passes --fmad=false).  A value the torch
// ops compute and then discard by mask is not computed.
//
// Bound: a sample lane reads its material id (4 B), geometric normal, wo,
// shading frame and tangent-space wo (18 floats), four draws, four
// wavelengths and four wavelength pdfs (13 floats) and up to two spectra
// at its four wavelengths (32 B), and writes f, wi, pdf and the
// wavelength pdfs (12 floats) and two flags: 210 B, 55 MB over the
// 262,144 lanes of a tile, 16 us at 3.35 TB/s; an eval lane reads 25
// floats and writes 5: 156 B, 12 us.  The material rows are a few hundred
// bytes in all, read through the cache.  Its float operations: ~80 and
// eight libm calls (Lambert) to ~400 and ~25 (a rough conductor: four
// complex Fresnel lanes, each an atan2f, a sinf, a cosf and four
// divisions), ~1.6 us of fp32 peak at most: the bytes bound them.
// Registers: 54 (sample) and 55 (eval), no spill; a 32 B stack frame (a
// local array, as the slow path of sinf / cosf keeps for arguments past
// ~1e5, which never occur here); 9 blocks of 128 threads an SM
// (launch_info; H100, nvcc 12.9).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// material kinds (scene/types.py)
constexpr int MAT_LAMBERT = 0;
constexpr int MAT_METAL = 1;
constexpr int MAT_GLASS = 2;
constexpr int MAT_PLASTIC = 3;
constexpr int MAT_PBR = 4;
constexpr int MAT_CLEARCOAT = 5;

// the torch path's python floats, as float32 (torch rounds a python float
// operand to the tensor's dtype)
constexpr float INV_PI = (float)(1.0 / 3.141592653589793);
constexpr float PI_F = (float)3.141592653589793;
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float SMOOTH_ALPHA = (float)1e-3;
constexpr float EPS_NORM = (float)(1e-20 * 1e-20);  // normalize3's eps^2
constexpr float LAMBDA_MIN = 360.0f;
constexpr float LAMBDA_SCALE = (float)(1.0 / (830.0 - 360.0));
// _schlick_fresnel's (1 - 1/7)**5 and 1 / ((1/7) (1 - 1/7)**6), python's
// double pow
constexpr float SCHLICK_FMAX_POW = (float)0x1.d9c4b004a1658p-2;
constexpr float SCHLICK_DIP = (float)0x1.1a6c1242b8b68p+4;
constexpr float MM = (float)0.001;
// x / 0.001 on a CUDA tensor: x times the reciprocal, taken in double
constexpr float PER_MM = (float)(1.0 / 0.001);

constexpr int MAX_IN = 32;

struct Column {              // a float per lane: lane i at p[i * stride]
    const float* p;
    long long stride;
};

struct Table {               // the material table's columns (contiguous)
    const int* mat_type;
    const float* base_coeff;         // (M, 3)
    const float* roughness;
    const float* metallic;
    const int* eta_row;
    const int* k_row;
    const float* const_eta;
    const int* thin;
    const float* coat_tint_coeff;    // (M, 3)
    const float* coat_thickness;
    const float* coat_roughness;
    const float* coat_eta;
};

struct Bank {                // spectrum r at wavelength lane l of lane i:
    const float* base[4];    // base[l][i * row[l] + r * col[l]]
    long long row[4];
    long long col[4];
    int n;
};

struct Args {
    int n;
    const void* mat;         // int32 or int64 material ids
    long long mat_stride;
    int mat_is64;
    int kinds;               // bit k: kind k is present in the scene
    Column in[MAX_IN];
    Table t;
    Bank bank;
};

// the columns both kernels read, then each kernel's own
enum {
    IN_GEO = 0, IN_WO = 3, IN_FRAME = 6, IN_WO_T = 15,
    // sample
    IN_UC = 18, IN_U = 19, IN_UC2 = 21, IN_UC3 = 22, IN_LAM = 23,
    IN_PDF = 27, IN_SAMPLE = 31,
    // eval
    IN_WI_T = 18, IN_ELAM = 21, IN_EVAL = 25,
};

// ---------------------------------------------------------------------------
// values
// ---------------------------------------------------------------------------

struct V3 {
    float x, y, z;
};

struct S4 {
    float v[4];
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    V3 r;
    r.x = x;
    r.y = y;
    r.z = z;
    return r;
}

__device__ __forceinline__ S4 s4(float a) {
    S4 r;
    for (int l = 0; l < 4; ++l) r.v[l] = a;
    return r;
}

// lane i's value of input column k, and of the three from k
__device__ __forceinline__ float col(const Args& A, int k, long long i) {
    return __ldg(A.in[k].p + i * A.in[k].stride);
}

__device__ __forceinline__ V3 col3(const Args& A, int k, long long i) {
    return v3(col(A, k, i), col(A, k + 1, i), col(A, k + 2, i));
}

__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }

__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

__device__ __forceinline__ float dot3(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ V3 normalize3(V3 v) {
    const float r = rsqrtf(clamp_min(dot3(v, v), EPS_NORM));
    return v3(v.x * r, v.y * r, v.z * r);
}

// torch.sign
__device__ __forceinline__ float sign(float x) {
    return (float)((0.0f < x) - (x < 0.0f));
}

__device__ __forceinline__ float s4_mean(const S4& s) {
    return (s.v[0] + s.v[1] + s.v[2] + s.v[3]) * 0.25f;
}

__device__ __forceinline__ S4 mul(const S4& a, float b) {
    S4 r;
    for (int l = 0; l < 4; ++l) r.v[l] = a.v[l] * b;
    return r;
}

__device__ __forceinline__ S4 mul(const S4& a, const S4& b) {
    S4 r;
    for (int l = 0; l < 4; ++l) r.v[l] = a.v[l] * b.v[l];
    return r;
}

__device__ __forceinline__ S4 one_minus(const S4& a) {
    S4 r;
    for (int l = 0; l < 4; ++l) r.v[l] = 1.0f - a.v[l];
    return r;
}

// microfacet.py's _sqrt0
__device__ __forceinline__ float sqrt0(float x) {
    return x > 0.0f ? sqrtf(x) : 0.0f;
}

// ---------------------------------------------------------------------------
// microfacet.py
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tan2_theta(V3 w) {
    const float c2 = w.z * w.z;
    return c2 > 0.0f ? (1.0f - c2) / clamp_min(c2, 1e-20f) : INFINITY;
}

__device__ __forceinline__ void cos_sin_phi(V3 w, float& cp, float& sp) {
    const float sin_t = sqrt0(clamp_min(1.0f - w.z * w.z, 0.0f));
    const bool safe = sin_t > 0.0f;
    const float inv = safe ? 1.0f / sin_t : 0.0f;
    cp = safe ? clamp(w.x * inv, -1.0f, 1.0f) : 1.0f;
    sp = safe ? clamp(w.y * inv, -1.0f, 1.0f) : 0.0f;
}

// distribution_d at ax = ay = a
__device__ float distribution_d(V3 wm, float a) {
    float t2 = tan2_theta(wm);
    const float c2 = wm.z * wm.z;
    float c4 = c2 * c2;
    const bool keep = isfinite(t2) && c4 > 0.0f;
    t2 = keep ? t2 : 0.0f;
    float cp, sp;
    cos_sin_phi(wm, cp, sp);
    const float a2 = clamp_min(a * a, 1e-12f);
    const float e = t2 * (cp * cp / a2 + sp * sp / a2);
    c4 = clamp_min(keep ? c4 : 1.0f, 1e-20f);
    const float e1 = 1.0f + e;
    const float d = 1.0f / (a * PI_F * a * c4 * (e1 * e1));
    return keep ? d : 0.0f;
}

__device__ float lambda_(V3 w, float a) {
    const float t2 = tan2_theta(w);
    const bool fin = isfinite(t2);
    float cp, sp;
    cos_sin_phi(w, cp, sp);
    const float ca = cp * a, sa = sp * a;
    const float a2 = ca * ca + sa * sa;
    const float lam = (sqrtf(1.0f + a2 * (fin ? t2 : 0.0f)) - 1.0f) * 0.5f;
    return fin ? lam : 0.0f;
}

__device__ __forceinline__ float g1(V3 w, float a) {
    return 1.0f / (1.0f + lambda_(w, a));
}

__device__ __forceinline__ float g2(V3 wo, V3 wi, float a) {
    return 1.0f / (1.0f + lambda_(wo, a) + lambda_(wi, a));
}

__device__ float vndf_pdf(V3 w, V3 wm, float a) {
    const float cos_w = fabsf(w.z);
    const float d = g1(w, a) / clamp_min(cos_w, 1e-20f) * distribution_d(wm, a)
        * fabsf(dot3(w, wm));
    return cos_w > 0.0f ? d : 0.0f;
}

__device__ V3 sample_vndf(V3 w, float ux, float uy, float a) {
    V3 wh = normalize3(v3(a * w.x, a * w.y, w.z));
    wh = sel(wh.z < 0.0f, neg(wh), wh);
    const V3 x_axis = v3(1.0f, 0.0f, 0.0f);
    const V3 t1 = wh.z < 0.99999f ? normalize3(v3(-wh.y, wh.x, 0.0f))
                                  : x_axis;
    const V3 t2 = cross3(wh, t1);
    const float r = sqrtf(ux);
    const float phi = uy * TWO_PI;
    const float px = r * cosf(phi);
    float py = r * sinf(phi);
    const float h = sqrtf(clamp_min(1.0f - px * px, 0.0f));
    const float lerp_f = (1.0f + wh.z) * 0.5f;
    py = h * (1.0f - lerp_f) + py * lerp_f;
    const float pz = sqrtf(clamp_min(1.0f - px * px - py * py, 0.0f));
    const V3 nh = v3(t1.x * px + t2.x * py + wh.x * pz,
                     t1.y * px + t2.y * py + wh.y * pz,
                     t1.z * px + t2.z * py + wh.z * pz);
    return normalize3(v3(a * nh.x, a * nh.y, clamp_min(nh.z, 1e-6f)));
}

__device__ __forceinline__ V3 reflect(V3 wo, V3 n) {
    const float d2 = dot3(wo, n) * 2.0f;
    return v3(n.x * d2 - wo.x, n.y * d2 - wo.y, n.z * d2 - wo.z);
}

__device__ V3 refract(V3 wi, V3 n, float eta, bool& ok) {
    const float cos_i = dot3(wi, n);
    const float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
    const float sin2_t = sin2_i / (eta * eta);
    const bool tir = sin2_t >= 1.0f;
    const float cos_t = sqrt0(clamp_min(1.0f - sin2_t, 0.0f));
    const float inv = 1.0f / eta;
    const float c = cos_i / eta - cos_t;
    const V3 m = neg(wi);
    const V3 wt = v3(m.x * inv + n.x * c, m.y * inv + n.y * c,
                     m.z * inv + n.z * c);
    ok = !tir && dot3(wt, wt) > 1e-12f;
    return normalize3(wt);
}

__device__ __forceinline__ bool same_hemisphere(V3 a, V3 b) {
    return a.z * b.z > 0.0f;
}

__device__ float fresnel_dielectric_lane(float ci, float eta) {
    const float sin2_i = 1.0f - ci * ci;
    const float sin2_t = sin2_i / (eta * eta);
    const float cos_t = sqrt0(clamp(1.0f - sin2_t, 0.0f, 1.0f));
    const float r_par = (eta * ci - cos_t) / (eta * ci + cos_t);
    const float r_per = (ci - eta * cos_t) / (ci + eta * cos_t);
    return (r_par * r_par + r_per * r_per) * 0.5f;
}

__device__ S4 fresnel_dielectric(float cos_i, const S4& eta) {
    const float ci = clamp(cos_i, 0.0f, 1.0f);
    S4 r;
    for (int l = 0; l < 4; ++l) r.v[l] = fresnel_dielectric_lane(ci, eta.v[l]);
    return r;
}

__device__ __forceinline__ void cdiv(float ar, float ai, float br, float bi,
                                     float& qr, float& qi) {
    const float d = clamp_min(br * br + bi * bi, 1e-20f);
    qr = (ar * br + ai * bi) / d;
    qi = (ai * br - ar * bi) / d;
}

__device__ float fresnel_complex_lane(float ci, float er, float ei) {
    const float sin2_i = 1.0f - ci * ci;
    const float e2r = er * er - ei * ei;
    const float e2i = 2.0f * er * ei;
    const float den = clamp_min(e2r * e2r + e2i * e2i, 1e-20f);
    const float s2t_r = sin2_i * e2r / den;
    const float s2t_i = -sin2_i * e2i / den;
    const float wr = 1.0f - s2t_r;
    const float wi = -s2t_i;
    const float mag = sqrtf(wr * wr + wi * wi);
    const float ang = atan2f(wi, wr) * 0.5f;
    const float sq = sqrtf(mag);
    const float ctr = sq * cosf(ang);
    const float cti = sq * sinf(ang);
    float pr, pi, sr, si;
    cdiv(er * ci - ctr, ei * ci - cti, er * ci + ctr, ei * ci + cti, pr, pi);
    const float ect_r = er * ctr - ei * cti;
    const float ect_i = er * cti + ei * ctr;
    cdiv(ci - ect_r, -ect_i, ci + ect_r, ect_i, sr, si);
    return ((pr * pr + pi * pi) + (sr * sr + si * si)) * 0.5f;
}

__device__ S4 fresnel_complex(float cos_i, const S4& eta, const S4& k) {
    const float ci = clamp(cos_i, 0.0f, 1.0f);
    S4 r;
    for (int l = 0; l < 4; ++l)
        r.v[l] = fresnel_complex_lane(ci, eta.v[l], k.v[l]);
    return r;
}

// ---------------------------------------------------------------------------
// bsdf.py's shared pieces
// ---------------------------------------------------------------------------

// sigmoid(c0 t^2 + c1 t + c2) at the four wavelengths (torch.sigmoid:
// 1 / (1 + exp(-x)))
__device__ S4 sigmoid_poly(const float* c, const float lam[4]) {
    const float c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    S4 r;
    for (int l = 0; l < 4; ++l) {
        const float t = (lam[l] - LAMBDA_MIN) * LAMBDA_SCALE;
        const float x = (c0 * t + c1) * t + c2;
        r.v[l] = 1.0f / (1.0f + expf(-x));
    }
    return r;
}

// grid.bank_pick: spectrum `row` at the lane's wavelengths, 0 off the bank
__device__ S4 bank_pick(const Bank& b, long long i, int row) {
    S4 r;
    for (int l = 0; l < 4; ++l)
        r.v[l] = (row >= 0 && row < b.n)
            ? __ldg(b.base[l] + i * b.row[l] + row * b.col[l]) : 0.0f;
    return r;
}

__device__ __forceinline__ V3 sample_cosine_hemisphere(float ux, float uy) {
    const float r = sqrtf(ux);
    const float theta = uy * TWO_PI;
    const float z = sqrtf(clamp_min(1.0f - ux, 0.0f));
    return v3(r * cosf(theta), r * sinf(theta), z);
}

__device__ __forceinline__ V3 mirror(V3 v) { return v3(-v.x, -v.y, v.z); }

__device__ __forceinline__ float smooth_alpha(float alpha, bool& smooth) {
    smooth = alpha < SMOOTH_ALPHA;
    return smooth ? 1.0f : alpha;
}

// _schlick_fresnel with r90 = 1, tint = 1 and exponent 5
__device__ S4 schlick_fresnel(float cos_theta, const S4& r0) {
    const float c = clamp(cos_theta, 0.0f, 1.0f);
    const float omc = 1.0f - c;
    const float p5 = powf(omc, 5.0f);
    const float dip = c * powf(omc, 6.0f);
    const float one = 1.0f;
    S4 r;
    for (int l = 0; l < 4; ++l) {
        const float d = one - r0.v[l];
        const float base = r0.v[l] + d * p5;
        const float f_max = r0.v[l] + d * SCHLICK_FMAX_POW;
        const float a = f_max * (one - one) * SCHLICK_DIP;
        r.v[l] = base - a * dip;
    }
    return r;
}

struct Lobe {
    S4 f;
    V3 wi;
    float pdf;
    bool ok, spec;
};

__device__ Lobe zero_lobe() {
    Lobe o;
    o.f = s4(0.0f);
    o.wi = v3(0.0f, 0.0f, 1.0f);
    o.pdf = 0.0f;
    o.ok = o.spec = false;
    return o;
}

__device__ __forceinline__ float pdf_reflect(float vndf, V3 wo, V3 wm) {
    return vndf / clamp_min(fabsf(dot3(wo, wm)) * 4.0f, 1e-12f);
}

// _schlick_r_sample: the R-only lobe (smooth -> delta)
__device__ Lobe schlick_r_sample(V3 wo, float ux, float uy, float alpha,
                                 const S4& r0) {
    Lobe o;
    bool smooth;
    alpha = smooth_alpha(alpha, smooth);
    o.spec = smooth;
    if (smooth) {
        o.wi = mirror(wo);
        o.f = schlick_fresnel(fabsf(o.wi.z), r0);
        o.pdf = 1.0f;
        o.ok = wo.z != 0.0f;
        return o;
    }
    const V3 wm = sample_vndf(wo, ux, uy, alpha);
    o.wi = reflect(wo, wm);
    const bool same = same_hemisphere(wo, o.wi);
    const float cos_o = clamp_min(fabsf(wo.z), 1e-12f);
    const S4 fres = schlick_fresnel(fabsf(dot3(wo, wm)), r0);
    const float d = distribution_d(wm, alpha);
    const float g = g2(wo, o.wi, alpha);
    o.f = same ? mul(fres, d * g / (cos_o * 4.0f)) : s4(0.0f);
    o.pdf = pdf_reflect(vndf_pdf(wo, wm, alpha), wo, wm);
    o.ok = wo.z != 0.0f && same && o.pdf > 0.0f;
    return o;
}

// _schlick_r_eval's terms that do not depend on r0 (the PBR lobes share
// them): whether the lobe is on, |wo . wm|, D G / (4 cos_o) and the pdf
struct REval {
    bool ok;
    float c, s, pdf;
};

__device__ REval schlick_r_eval(V3 wo, V3 wi, float alpha) {
    REval e;
    bool smooth;
    alpha = smooth_alpha(alpha, smooth);
    V3 wm = v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z);
    e.ok = !smooth && same_hemisphere(wo, wi) && dot3(wm, wm) > 0.0f
        && wo.z != 0.0f && wi.z != 0.0f;
    e.c = e.s = e.pdf = 0.0f;
    if (!e.ok) return e;
    wm = normalize3(wm);
    const float cos_o = clamp_min(fabsf(wo.z), 1e-12f);
    e.c = fabsf(dot3(wo, wm));
    const float d = distribution_d(wm, alpha);
    const float g = g2(wo, wi, alpha);
    e.s = d * g / (cos_o * 4.0f);
    e.pdf = pdf_reflect(vndf_pdf(wo, wm, alpha), wo, wm);
    return e;
}

// the lobe's f at r0
__device__ __forceinline__ S4 r_value(const REval& e, const S4& r0) {
    return e.ok ? mul(schlick_fresnel(e.c, r0), e.s) : s4(0.0f);
}

// ---------------------------------------------------------------------------
// the lane's material
// ---------------------------------------------------------------------------

struct Lane {
    long long i;
    int mat;
    float lam[4];
};

__device__ __forceinline__ S4 albedo(const Args& A, const Lane& L) {
    return sigmoid_poly(A.t.base_coeff + 3 * (long long)L.mat, L.lam);
}

__device__ __forceinline__ S4 eta_bank(const Args& A, const Lane& L,
                                       const int* rows) {
    const int row = __ldg(rows + L.mat);
    return bank_pick(A.bank, L.i, row < 0 ? 0 : row);
}

struct Pbr {
    S4 base;
    float metallic, alpha;
    S4 r0;
};

__device__ Pbr pbr_params(const Args& A, const Lane& L) {
    Pbr p;
    p.base = albedo(A, L);
    p.metallic = __ldg(A.t.metallic + L.mat);
    const float rough = __ldg(A.t.roughness + L.mat);
    p.alpha = rough * rough;
    const float ior = __ldg(A.t.const_eta + L.mat);
    const float r = (ior - 1.0f) / (ior + 1.0f);
    p.r0 = s4(r * r);
    return p;
}

struct Coat {
    float thickness, alpha;
    S4 r0, tint;
};

__device__ Coat coat_params(const Args& A, const Lane& L) {
    Coat c;
    c.thickness = __ldg(A.t.coat_thickness + L.mat);
    const float cr = __ldg(A.t.coat_roughness + L.mat);
    c.alpha = cr * cr;
    const float ior = __ldg(A.t.coat_eta + L.mat);
    const float rr = (ior - 1.0f) / (ior + 1.0f);
    c.r0 = s4(rr * rr);
    c.tint = sigmoid_poly(A.t.coat_tint_coeff + 3 * (long long)L.mat, L.lam);
    return c;
}

// exp(-sigma L), sigma = -ln(tint) / 1 mm, L = thickness / cos
__device__ S4 beer_lambert(const S4& tint, float thickness, float cos_theta) {
    const float l = thickness * MM / clamp_min(cos_theta, 1e-4f);
    const float x = l * PER_MM;
    S4 r;
    for (int l4 = 0; l4 < 4; ++l4)
        r.v[l4] = expf(logf(clamp_min(tint.v[l4], 1e-6f)) * x);
    return r;
}

__device__ __forceinline__ float cos_over_pi(float c) { return c * INV_PI; }

// ---- Lambert ----------------------------------------------------------------

__device__ Lobe lambert_sample(const Args& A, const Lane& L, V3 wo, float ux,
                               float uy) {
    Lobe o;
    const S4 alb = albedo(A, L);
    V3 wi = sample_cosine_hemisphere(ux, uy);
    if (wo.z < 0.0f) wi.z = -wi.z;
    const float p = cos_over_pi(fabsf(wi.z));
    o.f = mul(alb, p);
    o.wi = wi;
    o.pdf = p;
    o.ok = wo.z != 0.0f && wi.z != 0.0f;
    o.spec = false;
    return o;
}

__device__ __forceinline__ float lambert_lobe(V3 wo, V3 wi) {
    const float co = wo.z, ci = wi.z;
    const bool same = sign(co) == sign(ci) && co != 0.0f && ci != 0.0f;
    return same ? cos_over_pi(fabsf(ci)) : 0.0f;
}

// ---- conductor ----------------------------------------------------------------

__device__ S4 torrance_sparrow_f(V3 wo, V3 wi, V3 wm, const S4& eta,
                                 const S4& k, float alpha) {
    const float cos_o = fabsf(wo.z);
    const S4 fres = fresnel_complex(fabsf(dot3(wo, wm)), eta, k);
    const float d = distribution_d(wm, alpha);
    const float g = g2(wo, wi, alpha);
    return mul(fres, cos_o > 0.0f ? d * g / clamp_min(cos_o * 4.0f, 1e-12f)
                                  : 0.0f);
}

__device__ Lobe metal_sample(const Args& A, const Lane& L, V3 wo, float ux,
                             float uy) {
    Lobe o;
    const S4 eta = eta_bank(A, L, A.t.eta_row);
    const S4 k = eta_bank(A, L, A.t.k_row);
    const float rough = __ldg(A.t.roughness + L.mat);
    bool smooth;
    const float alpha = smooth_alpha(rough * rough, smooth);
    o.spec = smooth;
    if (smooth) {
        o.wi = mirror(wo);
        o.f = fresnel_complex(fabsf(o.wi.z), eta, k);
        o.pdf = 1.0f;
        o.ok = wo.z != 0.0f;
        return o;
    }
    const V3 wm = sample_vndf(wo, ux, uy, alpha);
    o.wi = reflect(wo, wm);
    const bool same = same_hemisphere(wo, o.wi);
    o.f = same ? torrance_sparrow_f(wo, o.wi, wm, eta, k, alpha) : s4(0.0f);
    o.pdf = pdf_reflect(vndf_pdf(wo, wm, alpha), wo, wm);
    o.ok = wo.z != 0.0f && same && o.pdf > 0.0f;
    return o;
}

__device__ void metal_eval(const Args& A, const Lane& L, V3 wo, V3 wi, S4& f,
                           float& pdf) {
    const S4 eta = eta_bank(A, L, A.t.eta_row);
    const S4 k = eta_bank(A, L, A.t.k_row);
    const float rough = __ldg(A.t.roughness + L.mat);
    bool smooth;
    const float alpha = smooth_alpha(rough * rough, smooth);
    V3 wm = v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z);
    const bool ok = !smooth && same_hemisphere(wo, wi) && dot3(wm, wm) > 0.0f
        && wo.z != 0.0f && wi.z != 0.0f;
    f = s4(0.0f);
    pdf = 0.0f;
    if (!ok) return;
    wm = normalize3(wm);
    f = torrance_sparrow_f(wo, wi, wm, eta, k, alpha);
    pdf = pdf_reflect(vndf_pdf(wo, wm, alpha), wo, wm);
}

// ---- dielectrics ----------------------------------------------------------

struct Dielectric {
    S4 eta_rel;
    float eta;               // eta_rel's hero lane
    bool entering, thin, smooth;
    float alpha;
};

__device__ Dielectric dielectric_params(const Args& A, const Lane& L,
                                        bool dispersive) {
    Dielectric p;
    S4 n_abs;
    if (dispersive) {
        n_abs = eta_bank(A, L, A.t.eta_row);
    } else {
        n_abs = s4(__ldg(A.t.const_eta + L.mat));
    }
    p.entering = dot3(col3(A, IN_GEO, L.i), col3(A, IN_WO, L.i)) > 0.0f;
    p.thin = __ldg(A.t.thin + L.mat) > 0;
    p.alpha = smooth_alpha(__ldg(A.t.roughness + L.mat), p.smooth);
    const bool ent = p.entering || p.thin;
    for (int l = 0; l < 4; ++l)
        p.eta_rel.v[l] = ent ? n_abs.v[l] : 1.0f / n_abs.v[l];
    p.eta = p.eta_rel.v[0];
    return p;
}

// _refl_trans_probs -> pr / sum and pt / sum, the choice's probabilities
__device__ __forceinline__ void refl_trans(float r, bool thin, float& pr,
                                           float& pt, float& sum) {
    const float t = 1.0f - r;
    const float r2 = r * r;
    const float r_thin = r2 > 1.0f
        ? 1.0f : r + (t * t * r) / clamp_min(1.0f - r2, 1e-12f);
    pr = thin ? r_thin : r;
    pt = t;
    sum = clamp_min(pr + pt, 1e-12f);
}

// _dielectric_sample; *choose_refl: the lobe choice (the glass's
// termination and the plastic's tint read it)
__device__ Lobe dielectric_sample(const Args& A, const Lane& L, V3 wo,
                                  float uc, float ux, float uy,
                                  bool dispersive, bool tinted,
                                  bool& terminate) {
    const Dielectric p = dielectric_params(A, L, dispersive);
    Lobe o;
    bool choose_refl;
    o.spec = p.smooth;
    if (p.smooth) {
        const S4 fres = fresnel_dielectric(fabsf(wo.z), p.eta_rel);
        float pr, pt, sum;
        refl_trans(s4_mean(fres), p.thin, pr, pt, sum);
        choose_refl = uc < pr / sum;
        if (choose_refl) {
            o.wi = mirror(wo);
            o.f = fres;
            o.pdf = pr / sum;
            o.ok = fabsf(wo.z) > 1e-6f;
        } else {
            const S4 one_m_f = one_minus(fres);
            if (p.thin) {
                o.wi = neg(wo);
                o.f = one_m_f;
                o.ok = true;
            } else {
                const V3 n = v3(0.0f, 0.0f, p.entering ? 1.0f : -1.0f);
                o.wi = refract(wo, n, p.eta, o.ok);
                o.f = mul(one_m_f, 1.0f / (p.eta * p.eta));
            }
            o.pdf = pt / sum;
        }
    } else {
        const float alpha = p.alpha;
        const V3 wm = sample_vndf(wo, ux, uy, alpha);
        const float c_om = fabsf(dot3(wo, wm));
        const S4 fres = fresnel_dielectric(c_om, p.eta_rel);
        float pr, pt, sum;
        refl_trans(s4_mean(fres), p.thin, pr, pt, sum);
        choose_refl = uc < pr / sum;
        const float d = distribution_d(wm, alpha);
        const float cos_o = clamp_min(fabsf(wo.z), 1e-12f);
        const float vndf = vndf_pdf(wo, wm, alpha);
        if (choose_refl) {
            o.wi = reflect(wo, wm);
            const bool same = same_hemisphere(wo, o.wi);
            const float g = g2(wo, o.wi, alpha);
            o.f = mul(fres, d * g / (cos_o * 4.0f));
            o.pdf = pdf_reflect(vndf, wo, wm) * (pr / sum);
            o.ok = same && c_om > 1e-6f;
        } else {
            const float prob_t = pt / sum;
            if (p.thin) {
                o.wi = neg(wo);
                o.f = one_minus(fres);
                o.pdf = prob_t;
                o.ok = true;
            } else {
                bool refr_ok;
                o.wi = refract(wo, p.entering ? wm : neg(wm), p.eta, refr_ok);
                const float dim = dot3(o.wi, wm);
                const float x = dim + dot3(wo, wm) / p.eta;
                const float denom = clamp_min(x * x, 1e-12f);
                const float dwm_dwi = fabsf(dim) / denom;
                const float g = g2(wo, o.wi, alpha);
                const float s = d * g * fabsf(dim) * c_om
                    / (denom * cos_o * (p.eta * p.eta));
                o.f = mul(one_minus(fres), s);
                o.pdf = vndf * dwm_dwi * prob_t;
                o.ok = refr_ok && !same_hemisphere(wo, o.wi)
                    && fabsf(o.wi.z) > 0.0f;
            }
        }
    }
    o.ok = o.ok && wo.z != 0.0f;
    if (tinted && dot3(o.wi, wo) < 0.0f && !choose_refl)
        o.f = mul(o.f, albedo(A, L));
    terminate = dispersive && !choose_refl && o.ok;
    return o;
}

__device__ void dielectric_eval(const Args& A, const Lane& L, V3 wo, V3 wi,
                                bool dispersive, bool tinted, S4& f,
                                float& pdf) {
    const Dielectric p = dielectric_params(A, L, dispersive);
    const float cos_o = wo.z, cos_i = wi.z;
    const bool is_refl = cos_i * cos_o > 0.0f;
    const float etap = is_refl ? 1.0f
                               : (cos_o > 0.0f ? p.eta : 1.0f / p.eta);
    V3 wm = v3(wi.x * etap + wo.x, wi.y * etap + wo.y, wi.z * etap + wo.z);
    bool ok = cos_i != 0.0f && cos_o != 0.0f && dot3(wm, wm) > 0.0f
        && !p.smooth;
    wm = normalize3(wm);
    wm = sel(wm.z < 0.0f, neg(wm), wm);
    const float dwi = dot3(wm, wi), dwo = dot3(wm, wo);
    ok = ok && dwi * cos_i >= 0.0f && dwo * cos_o >= 0.0f;
    f = s4(0.0f);
    pdf = 0.0f;
    if (!ok) return;
    const float alpha = p.alpha;
    const float c_om = fabsf(dot3(wo, wm));
    const S4 fres = fresnel_dielectric(c_om, p.eta_rel);
    float pr, pt, sum;
    refl_trans(s4_mean(fres), p.thin, pr, pt, sum);
    const float d = distribution_d(wm, alpha);
    const float g = g2(wo, wi, alpha);
    const float aco = clamp_min(fabsf(cos_o), 1e-12f);
    const float vnd = vndf_pdf(wo, wm, alpha);
    if (is_refl) {
        f = mul(fres, d * g / (aco * 4.0f));
        pdf = pdf_reflect(vnd, wo, wm) * pr / sum;
    } else {
        const float d_im = dot3(wi, wm);
        const float x = d_im + dot3(wo, wm) / p.eta;
        const float denom = clamp_min(x * x, 1e-12f);
        f = mul(one_minus(fres), d * g * fabsf(d_im) * c_om
                / (denom * aco * (p.eta * p.eta)));
        pdf = p.thin ? pt / sum : vnd * (fabsf(d_im) / denom) * pt / sum;
        if (tinted) f = mul(f, albedo(A, L));
    }
}

// ---- PBR ----------------------------------------------------------------------

__device__ Lobe pbr_sample(const Pbr& p, V3 wo, float uc, float uc2, float ux,
                           float uy) {
    if (uc <= p.metallic) return schlick_r_sample(wo, ux, uy, p.alpha, p.base);
    const float fbar = s4_mean(schlick_fresnel(fabsf(wo.z), p.r0));
    if (uc2 < fbar) {
        Lobe o = schlick_r_sample(wo, ux, uy, p.alpha, p.r0);
        o.pdf = o.pdf * fbar;
        return o;
    }
    Lobe o;
    V3 wi = sample_cosine_hemisphere(ux, uy);
    if (wo.z < 0.0f) wi.z = -wi.z;
    const float w = cos_over_pi(fabsf(wi.z)) * (1.0f - fbar);
    o.f = mul(p.base, w);
    o.wi = wi;
    o.pdf = w;
    o.ok = wo.z != 0.0f && wi.z != 0.0f;
    o.spec = false;
    return o;
}

__device__ void pbr_eval(const Pbr& p, V3 wo, V3 wi, S4& f, float& pdf) {
    const REval r = schlick_r_eval(wo, wi, p.alpha);
    const S4 f_metal = r_value(r, p.base), f_spec = r_value(r, p.r0);
    const float fbar = s4_mean(schlick_fresnel(fabsf(wo.z), p.r0));
    const float lamb = lambert_lobe(wo, wi);
    const float omf = 1.0f - fbar;
    const float omm = 1.0f - p.metallic;
    const float pdf_diel = fbar * r.pdf + omf * lamb;
    for (int l = 0; l < 4; ++l) {
        const float f_diel = f_spec.v[l] + p.base.v[l] * lamb * omf;
        f.v[l] = f_metal.v[l] * p.metallic + f_diel * omm;
    }
    pdf = p.metallic * r.pdf + omm * pdf_diel;
}

// ---- clearcoat ----------------------------------------------------------------

__device__ Lobe clearcoat_sample(const Args& A, const Lane& L, V3 wo, float uc,
                                 float uc2, float uc3, float ux, float uy) {
    const Coat c = coat_params(A, L);
    const bool has_coat = c.thickness > 0.0f;
    const float e_coat = has_coat ? s4_mean(schlick_fresnel(fabsf(wo.z), c.r0))
                                  : 0.0f;
    if (uc < e_coat) {
        Lobe o = schlick_r_sample(wo, ux, uy, c.alpha, c.r0);
        o.pdf = o.pdf * e_coat;
        return o;
    }
    Lobe o = pbr_sample(pbr_params(A, L), wo, uc2, uc3, ux, uy);
    if (has_coat) {        // else f and pdf times 1
        const S4 att = mul(beer_lambert(c.tint, c.thickness, fabsf(wo.z)),
                           beer_lambert(c.tint, c.thickness, fabsf(o.wi.z)));
        o.f = mul(o.f, att);
        o.pdf = o.pdf * (1.0f - e_coat);
    }
    return o;
}

__device__ void clearcoat_eval(const Args& A, const Lane& L, V3 wo, V3 wi,
                               S4& f, float& pdf) {
    const Coat c = coat_params(A, L);
    const bool has_coat = c.thickness > 0.0f;
    const REval r = schlick_r_eval(wo, wi, c.alpha);
    const S4 f_c = r_value(r, c.r0);
    const float e_coat = has_coat ? s4_mean(schlick_fresnel(fabsf(wo.z), c.r0))
                                  : 0.0f;
    S4 f_b;
    float pdf_b;
    pbr_eval(pbr_params(A, L), wo, wi, f_b, pdf_b);
    const S4 att = has_coat
        ? mul(beer_lambert(c.tint, c.thickness, fabsf(wo.z)),
              beer_lambert(c.tint, c.thickness, fabsf(wi.z)))
        : s4(1.0f);
    for (int l = 0; l < 4; ++l)
        f.v[l] = (has_coat ? f_c.v[l] : 0.0f) + f_b.v[l] * att.v[l];
    pdf = e_coat * r.pdf + (1.0f - e_coat) * pdf_b;
}

// ---------------------------------------------------------------------------
// the lanes
// ---------------------------------------------------------------------------

__device__ __forceinline__ int material_of(const Args& A, long long i) {
    return A.mat_is64
        ? (int)__ldg((const long long*)A.mat + i * A.mat_stride)
        : __ldg((const int*)A.mat + i * A.mat_stride);
}

__device__ __forceinline__ bool opaque(int kind) {
    return kind == MAT_LAMBERT || kind == MAT_METAL || kind == MAT_PBR
        || kind == MAT_CLEARCOAT;
}

// _geo_sidedness: sign(wo . ng) == sign(wi . ng) in the tangent frame
__device__ bool geo_sidedness(const Args& A, long long i, V3 wo_t, V3 wi_t) {
    const V3 ng = col3(A, IN_GEO, i);
    const V3 t = col3(A, IN_FRAME, i), b = col3(A, IN_FRAME + 3, i),
             n = col3(A, IN_FRAME + 6, i);
    const V3 ng_t = v3(dot3(t, ng), dot3(b, ng), dot3(n, ng));
    return sign(dot3(wo_t, ng_t)) == sign(dot3(wi_t, ng_t));
}

// out: f (4 rows), wi_t (3), pdf, the wavelength pdfs (4), n lanes a row;
// flags: sampled, specular
__device__ void sample_lane(const Args& A, long long i, float* out,
                            unsigned char* flags) {
    Lane L;
    L.i = i;
    L.mat = material_of(A, i);
    for (int l = 0; l < 4; ++l) L.lam[l] = col(A, IN_LAM + l, i);
    const int kind = __ldg(A.t.mat_type + L.mat);
    const V3 wo = col3(A, IN_WO_T, i);
    const float uc = col(A, IN_UC, i);
    const float ux = col(A, IN_U, i), uy = col(A, IN_U + 1, i);
    Lobe o = zero_lobe();
    bool terminate = false;
    if (kind >= 0 && kind < 31 && ((A.kinds >> kind) & 1)) {
        switch (kind) {
        case MAT_LAMBERT:
            o = lambert_sample(A, L, wo, ux, uy);
            break;
        case MAT_METAL:
            o = metal_sample(A, L, wo, ux, uy);
            break;
        case MAT_GLASS:
            o = dielectric_sample(A, L, wo, uc, ux, uy, true, false,
                                  terminate);
            break;
        case MAT_PLASTIC:
            o = dielectric_sample(A, L, wo, uc, ux, uy, false, true,
                                  terminate);
            break;
        case MAT_PBR:
            o = pbr_sample(pbr_params(A, L), wo, uc, col(A, IN_UC2, i), ux,
                           uy);
            break;
        case MAT_CLEARCOAT:
            o = clearcoat_sample(A, L, wo, uc, col(A, IN_UC2, i),
                                 col(A, IN_UC3, i), ux, uy);
            break;
        default:
            break;
        }
    }
    // sampled.terminate_secondary
    float pdf4[4];
    for (int l = 0; l < 4; ++l) pdf4[l] = col(A, IN_PDF + l, i);
    const bool done = pdf4[1] == 0.0f && pdf4[2] == 0.0f && pdf4[3] == 0.0f;
    if (terminate && !done) {
        pdf4[0] = pdf4[0] * 0.25f;
        pdf4[1] = pdf4[2] = pdf4[3] = 0.0f;
    }
    bool sampled = o.ok;
    if (sampled && opaque(kind))
        sampled = geo_sidedness(A, i, wo, o.wi);
    const long long n = A.n;
    for (int l = 0; l < 4; ++l) out[l * n + i] = o.f.v[l];
    out[4 * n + i] = o.wi.x;
    out[5 * n + i] = o.wi.y;
    out[6 * n + i] = o.wi.z;
    out[7 * n + i] = o.pdf;
    for (int l = 0; l < 4; ++l) out[(8 + l) * n + i] = pdf4[l];
    flags[i] = sampled;
    flags[n + i] = o.spec;
}

// out: f (4 rows), pdf
__device__ void eval_lane(const Args& A, long long i, float* out) {
    Lane L;
    L.i = i;
    L.mat = material_of(A, i);
    for (int l = 0; l < 4; ++l) L.lam[l] = col(A, IN_ELAM + l, i);
    const int kind = __ldg(A.t.mat_type + L.mat);
    const V3 wo = col3(A, IN_WO_T, i);
    const V3 wi = col3(A, IN_WI_T, i);
    S4 f = s4(0.0f);
    float pdf = 0.0f;
    if (kind >= 0 && kind < 31 && ((A.kinds >> kind) & 1)) {
        switch (kind) {
        case MAT_LAMBERT: {
            const float w = lambert_lobe(wo, wi);
            f = mul(albedo(A, L), w);
            pdf = w;
            break;
        }
        case MAT_METAL:
            metal_eval(A, L, wo, wi, f, pdf);
            break;
        case MAT_GLASS:
            dielectric_eval(A, L, wo, wi, true, false, f, pdf);
            break;
        case MAT_PLASTIC:
            dielectric_eval(A, L, wo, wi, false, true, f, pdf);
            break;
        case MAT_PBR:
            pbr_eval(pbr_params(A, L), wo, wi, f, pdf);
            break;
        case MAT_CLEARCOAT:
            clearcoat_eval(A, L, wo, wi, f, pdf);
            break;
        default:
            break;
        }
    }
    if (opaque(kind) && !geo_sidedness(A, i, wo, wi)) {
        f = s4(0.0f);
        pdf = 0.0f;
    }
    const long long n = A.n;
    for (int l = 0; l < 4; ++l) out[l * n + i] = f.v[l];
    out[4 * n + i] = pdf;
}

Args make_args(int n, const void* mat, long long mat_stride, int mat_is64,
               int kinds, const long long* cols, int n_cols,
               const long long* table, const long long* bank, int n_bank) {
    Args a;
    a.n = n;
    a.mat = mat;
    a.mat_stride = mat_stride;
    a.mat_is64 = mat_is64;
    a.kinds = kinds;
    for (int k = 0; k < MAX_IN; ++k) {
        a.in[k].p = k < n_cols ? (const float*)cols[2 * k] : nullptr;
        a.in[k].stride = k < n_cols ? cols[2 * k + 1] : 0;
    }
    Table& t = a.t;
    t.mat_type = (const int*)table[0];
    t.base_coeff = (const float*)table[1];
    t.roughness = (const float*)table[2];
    t.metallic = (const float*)table[3];
    t.eta_row = (const int*)table[4];
    t.k_row = (const int*)table[5];
    t.const_eta = (const float*)table[6];
    t.thin = (const int*)table[7];
    t.coat_tint_coeff = (const float*)table[8];
    t.coat_thickness = (const float*)table[9];
    t.coat_roughness = (const float*)table[10];
    t.coat_eta = (const float*)table[11];
    for (int l = 0; l < 4; ++l) {
        a.bank.base[l] = (const float*)bank[3 * l];
        a.bank.row[l] = bank[3 * l + 1];
        a.bank.col[l] = bank[3 * l + 2];
    }
    a.bank.n = n_bank;
    return a;
}

// ---- launch ----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
bsdf_sample_kernel(const __grid_constant__ Args A, float* __restrict__ out,
                   unsigned char* __restrict__ flags) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i < A.n) sample_lane(A, i, out, flags);
}

__global__ void __launch_bounds__(THREADS)
bsdf_eval_kernel(const __grid_constant__ Args A, float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i < A.n) eval_lane(A, i, out);
}

}  // namespace

extern "C" {

// The sample (eval 0) or eval (eval 1) kernel over n lanes.
// mat: the lanes' material ids (int64 where mat_is64, else int32), lane i
// at element i * mat_stride; kinds: bit k set where kind k is present;
// cols: n_cols (pointer, stride in floats) pairs, in the order of the
// IN_ enum (IN_SAMPLE columns for a sample, IN_EVAL for an eval); table:
// the 12 column pointers of Table, in its order; bank: (base, row stride,
// column step) of each wavelength lane, n_bank spectra.  out: (12, n)
// floats and flags (2, n) bytes (sample) or out (5, n) floats (eval).
// Returns the launch's cudaError (0: queued on the stream).
int launch_bsdf(int eval, int n, const void* mat, long long mat_stride,
                int mat_is64, int kinds, const long long* cols, int n_cols,
                const long long* table, const long long* bank, int n_bank,
                void* out, void* flags, void* stream) {
    if (n <= 0 || n_cols != (eval ? IN_EVAL : IN_SAMPLE))
        return (int)cudaErrorInvalidValue;
    const Args a = make_args(n, mat, mat_stride, mat_is64, kinds, cols,
                             n_cols, table, bank, n_bank);
    const int blocks = (n + THREADS - 1) / THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (eval)
        bsdf_eval_kernel<<<blocks, THREADS, 0, st>>>(a, (float*)out);
    else
        bsdf_sample_kernel<<<blocks, THREADS, 0, st>>>(
            a, (float*)out, (unsigned char*)flags);
    return (int)cudaGetLastError();
}

// out: [registers, local bytes a thread, resident blocks an SM, grid] of
// a launch of the sample (eval 0) or eval kernel over n lanes.
int bsdf_launch_info(int eval, int n, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = eval ? cudaFuncGetAttributes(&attr, bsdf_eval_kernel)
                           : cudaFuncGetAttributes(&attr, bsdf_sample_kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    err = eval
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &out[2], bsdf_eval_kernel, THREADS, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &out[2], bsdf_sample_kernel, THREADS, 0);
    out[3] = (n + THREADS - 1) / THREADS;
    return (int)err;
}

}  // extern "C"
