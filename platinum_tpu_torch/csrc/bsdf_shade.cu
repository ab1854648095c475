// The principled BSDF of models/bsdf.py in one pass per lane, on Hopper
// (sm_90a): `bsdf_sample_kernel` importance-samples it (bsdf.sample, with
// the mixture pdf) and `bsdf_evaluate_kernel` evaluates it for a given
// direction (bsdf.evaluate, the NEE path).
//
// It replaces no TPU kernel: the JAX package's BSDF is plain JAX, fused by
// XLA (platinum_tpu/models/bsdf.py). It was added because the port ran the
// same code as ~1,600 eager PyTorch operations a bounce, each a full pass
// over device memory, most of them on strided column views of the gathered
// material rows; the plain functions (`sample_plain`, `evaluate_plain`)
// stay beside the wrappers as the reference the tests hold this to.
//
// What it computes is the plain code's function, lobe for lobe and clamp
// for clamp: every lobe and switch of ALL_FEATURES that the BSDF reads
// (metallic, transparent, clearcoat, smooth, aniso, thin, tex_rough), the
// per-material energy rows and the LUT path (clamp-to-edge linear lookups
// in 1-4 dimensions, `_axis`'s index math), multiscatter and the mixture
// pdf on and off. The switches come as one bit mask (`mode`), so their
// branches are uniform across a warp and one build serves every scene.
// Each value is formed by the plain code's operations in its order, one
// rounding each: the source is built with -fmad=false, so no product is
// fused into a sum that the plain code rounds apart, and division and
// square root are IEEE (no fast math). Where the plain code computes a
// lobe and then discards it with `torch.where`, this code computes only
// the lobe it keeps, which gives the same values. What is left between
// the two is sinf, cosf and sqrtf against PyTorch's, a few ulps.
//
// What bounds it on the card: bytes. A lane reads its direction(s) and
// random numbers (12-36 B), ten material columns of one 64-byte gathered
// row, its flags, material index and energy-average row, and writes
// wi, f, pdf and flags (32 B) or f and pdf (16 B): 100-140 B a lane
// against a few hundred to a few thousand flops. The inputs are read where they
// lie (each field by pointer, lane stride and component stride: the
// context's fields are column views, so nothing is copied first), the
// LUTs and the energy rows, a few hundred KB in all, through the
// read-only cache, and nothing but the outputs is written.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;     // float32(np.pi)
constexpr float kTwoPi = 6.28318530717958647692f;  // float32(2 * np.pi)
constexpr float kMinCos = 1.5e-3f;                 // bsdf.MIN_COS
constexpr float kSmoothAlpha = 1e-3f;              // ggx.SMOOTH_ALPHA
constexpr float kCoatIor = 1.5f;                   // bsdf.CLEARCOAT_IOR
constexpr int kThreads = 256;

// bsdf.SAMPLE_* flags
constexpr int kReflected = 1, kTransmitted = 2, kDiffuse = 4, kGlossy = 8,
              kSpecular = 16, kEmitted = 32;
// render/types MAT_* flags
constexpr int kMatAniso = 1, kMatEmissive = 2, kMatThin = 4;
// `mode` bits: the features (bsdf.FEATURE_BITS) and the switches
constexpr int kMetallic = 1, kTransparent = 2, kClearcoat = 4, kSmooth = 8,
              kAniso = 16, kThin = 32, kMultiscatter = 256,
              kMixturePdf = 512, kRows = 1024;
// Luts fields, in the dataclass's order
enum {
  kE, kEAvg, kEMs, kEMsAvg, kETransIn, kETransOut, kETransInAvg,
  kETransOutAvg, kEAniso, kEAvgAniso, kEMsAniso, kEMsAvgAniso, kFCoatAvg,
  kEFCoat, kNumLuts
};

// A per-lane field: element [lane * s + k * c]
struct Col {
  const float* p;
  long long s, c;
};
// A LUT: contiguous, shape (n[0], ..., n[dims - 1])
struct Lut {
  const float* p;
  int n[4];
};
struct Params {
  int n, mode;
  Col albedo, rough, metal, trans, ior, aniso, rot, coat, coat_rough, avg;
  const int* flags;
  long long flags_s;
  const int* mat;
  long long mat_s;
  const float* energy;  // (energy_rows, 6), energy_k rows a material
  int energy_k, energy_rows;
  Col wo, a, b;         // sample: wo, r4, rc; evaluate: wo, wi
  Lut lut[kNumLuts];
  float* o_wi;
  float* o_f;
  float* o_pdf;
  int* o_flags;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
// torch.sum(a * b, -1): the products, then summed in order
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot3(a, a)); }
// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): a NaN stays NaN
__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}
// frame.normalize
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float l = at_least(norm3(a), 1e-20f);
  return v3(a.x / l, a.y / l, a.z / l);
}
// frame.cross
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float sgn(float x) { return x < 0.f ? -1.f : 1.f; }

__device__ __forceinline__ V3 load3(const Col& c, long long i) {
  const float* q = c.p + i * c.s;
  return v3(q[0], q[c.c], q[2 * c.c]);
}
__device__ __forceinline__ float load1(const Col& c, long long i) {
  return c.p[i * c.s];
}

// ---------------------------------------------------------------------------
// fresnel.py
// ---------------------------------------------------------------------------

__device__ float fresnel_dielectric(float cos_theta, float ior) {
  const float c = clamp_to(cos_theta, 0.f, 1.f);
  const float sin2_t = (1.f - c * c) / at_least(ior * ior, 1e-20f);
  const float cos_t = sqrtf(at_least(1.f - sin2_t, 0.f));
  const float par = (ior * c - cos_t) / at_least(ior * c + cos_t, 1e-20f);
  const float perp = (c - ior * cos_t) / at_least(c + ior * cos_t, 1e-20f);
  const float f = 0.5f * (par * par + perp * perp);
  return sin2_t >= 1.f ? 1.f : f;
}

__device__ __forceinline__ float schlick(float f0, float cos_theta) {
  const float k = 1.f - clamp_to(cos_theta, 0.f, 1.f);
  const float k2 = k * k;
  const float w = k2 * k2 * k;
  return f0 + (1.f - f0) * w;
}

__device__ __forceinline__ float avg_dielectric_fresnel_fit(float ior) {
  const float hi = (ior - 1.f) / (4.08567f + 1.00071f * ior);
  const float lo = 0.997118f + 0.1014f * ior - 0.965241f * ior * ior -
                   0.130607f * (ior * ior * ior);
  return ior >= 1.f ? hi : lo;
}

__device__ __forceinline__ float avg_conductor_fresnel(float albedo) {
  return (20.f * albedo + 1.f) / 21.f;
}

// ---------------------------------------------------------------------------
// ggx.py; alpha = (ax, ay)
// ---------------------------------------------------------------------------

struct A2 {
  float x, y;
};

__device__ float mdf(A2 a, V3 w) {
  const float cos2 = w.z * w.z;
  const float cos4 = cos2 * cos2;
  float k = (w.x * w.x / (a.x * a.x) + w.y * w.y / (a.y * a.y)) /
            at_least(cos2, 1e-20f);
  k = (1.f + k) * (1.f + k);
  return 1.f / (kPi * a.x * a.y * at_least(cos4 * k, 1e-20f));
}

__device__ float lambda_(A2 a, V3 w) {
  const float cos2 = at_least(w.z * w.z, 1e-20f);
  const float alpha2 = a.x == a.y
                           ? a.x * a.x
                           : a.x * a.x * w.x * w.x + a.y * a.y * w.y * w.y;
  return (sqrtf(1.f + alpha2 / cos2) - 1.f) * 0.5f;
}

__device__ __forceinline__ float g1(A2 a, V3 w) {
  return 1.f / (1.f + lambda_(a, w));
}

__device__ __forceinline__ float g2(A2 a, V3 wo, V3 wi) {
  return 1.f / (1.f + lambda_(a, wo) + lambda_(a, wi));
}

__device__ float vmdf(A2 a, V3 w, V3 wm) {
  return g1(a, w) / at_least(fabsf(w.z), 1e-20f) * mdf(a, wm) *
         fabsf(dot3(w, wm));
}

__device__ float ggx_pdf(A2 a, V3 wo, V3 wm) {
  return vmdf(a, wo, wm) / at_least(4.f * fabsf(dot3(wo, wm)), 1e-20f);
}

__device__ float single_scatter_brdf(A2 a, V3 wo, V3 wi, V3 wm) {
  return mdf(a, wm) * g2(a, wo, wi) /
         at_least(4.f * fabsf(wo.z) * fabsf(wi.z), 1e-20f);
}

__device__ V3 sample_vmdf(A2 a, V3 w, float u0, float u1) {
  V3 wh = normalize3(v3(w.x * a.x, w.y * a.y, w.z));
  wh = scale(wh, sgn(wh.z));
  const V3 braw = cross3(v3(0.f, 0.f, 1.f), wh);
  const float blen = at_least(norm3(braw), 1e-20f);
  const V3 b = wh.z < 0.9999f ? v3(braw.x / blen, braw.y / blen, braw.z / blen)
                              : v3(1.f, 0.f, 0.f);
  const V3 t = cross3(wh, b);
  // samplers.sample_disk
  const float r = sqrtf(u0);
  const float theta = kTwoPi * u1;
  const float px = r * cosf(theta), py0 = r * sinf(theta);
  const float h = sqrtf(at_least(1.f - px * px, 0.f));
  const float mix_t = 0.5f * wh.z + 0.5f;
  const float py = h * (1.f - mix_t) + py0 * mix_t;
  const float pz = sqrtf(at_least(1.f - px * px - py * py, 0.f));
  const V3 nh = v3(b.x * px + t.x * py + wh.x * pz,
                   b.y * px + t.y * py + wh.y * pz,
                   b.z * px + t.z * py + wh.z * pz);
  return normalize3(v3(a.x * nh.x, a.y * nh.y, at_least(nh.z, 1e-6f)));
}

// Metal-convention reflect and refract (i points toward the surface)
__device__ __forceinline__ V3 reflect3(V3 i, V3 n) {
  const float d = 2.f * dot3(i, n);
  return v3(i.x - d * n.x, i.y - d * n.y, i.z - d * n.z);
}

__device__ V3 refract3(V3 i, V3 n, float eta) {
  const float cos_i = dot3(n, i);
  const float k = 1.f - eta * eta * (1.f - cos_i * cos_i);
  if (k < 0.f) return v3(0.f, 0.f, 0.f);
  const float q = eta * cos_i + sqrtf(at_least(k, 0.f));
  return v3(eta * i.x - q * n.x, eta * i.y - q * n.y, eta * i.z - q * n.z);
}

// ---------------------------------------------------------------------------
// luts.py: Metal-style normalized clamp-to-edge linear sampling
// ---------------------------------------------------------------------------

struct Axis {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Axis axis(float coord, int n) {
  const float x = clamp_to(coord * (float)n - 0.5f, 0.f, (float)n - 1.f);
  const float x0 = floorf(x);
  Axis a;
  a.f = x - x0;
  // a NaN coordinate gives no index past the table
  a.i0 = x0 >= 0.f && x0 <= (float)(n - 1) ? (int)x0 : 0;
  a.i1 = min(a.i0 + 1, n - 1);
  return a;
}

__device__ __forceinline__ float tap(const float* p, int i) {
  return __ldg(p + i);
}

__device__ float sample1d(const Lut& l, float u) {
  const Axis x = axis(u, l.n[0]);
  return tap(l.p, x.i0) * (1.f - x.f) + tap(l.p, x.i1) * x.f;
}

// (H, W) indexed [v, u]; `base` offsets into a larger table
__device__ float bilerp(const float* p, int w, const Axis& x, const Axis& y) {
  return (tap(p, y.i0 * w + x.i0) * (1.f - x.f) +
          tap(p, y.i0 * w + x.i1) * x.f) *
             (1.f - y.f) +
         (tap(p, y.i1 * w + x.i0) * (1.f - x.f) +
          tap(p, y.i1 * w + x.i1) * x.f) *
             y.f;
}

__device__ float sample2d(const Lut& l, float u, float v) {
  const Axis x = axis(u, l.n[1]);
  const Axis y = axis(v, l.n[0]);
  return bilerp(l.p, l.n[1], x, y);
}

// (D, H, W) indexed [w, v, u]
__device__ float trilerp(const float* p, int h, int w, const Axis& x,
                         const Axis& y, const Axis& z) {
  const int plane = h * w;
  return bilerp(p + z.i0 * plane, w, x, y) * (1.f - z.f) +
         bilerp(p + z.i1 * plane, w, x, y) * z.f;
}

__device__ float sample3d(const Lut& l, float u, float v, float w_) {
  const Axis x = axis(u, l.n[2]);
  const Axis y = axis(v, l.n[1]);
  const Axis z = axis(w_, l.n[0]);
  return trilerp(l.p, l.n[1], l.n[2], x, y, z);
}

// (Q, D, H, W) indexed [q, w, v, u]
__device__ float sample4d(const Lut& l, float u, float v, float w_, float q) {
  const Axis x = axis(u, l.n[3]);
  const Axis y = axis(v, l.n[2]);
  const Axis z = axis(w_, l.n[1]);
  const Axis a = axis(q, l.n[0]);
  const int vol = l.n[1] * l.n[2] * l.n[3];
  return trilerp(l.p + a.i0 * vol, l.n[2], l.n[3], x, y, z) * (1.f - a.f) +
         trilerp(l.p + a.i1 * vol, l.n[2], l.n[3], x, y, z) * a.f;
}

// ---------------------------------------------------------------------------
// The shading context of one lane (bsdf.ShadingContext)
// ---------------------------------------------------------------------------

struct Mat {
  float albedo[3];
  float rough, metal, trans, ior, coat, coat_rough;
  float an;        // |anisotropy| where the material is anisotropic
  float cos_a, sin_a;  // the anisotropy rotation (aniso feature only)
  float avg0, avg1;    // energy_avg_row[..., 0:2] (rows path only)
  A2 alpha, coat_alpha;
  int flags, mat;
};

__device__ Mat load_mat(const Params& p, long long i) {
  Mat m;
  const float* al = p.albedo.p + i * p.albedo.s;
  m.albedo[0] = al[0];
  m.albedo[1] = al[p.albedo.c];
  m.albedo[2] = al[2 * p.albedo.c];
  m.rough = load1(p.rough, i);
  m.metal = load1(p.metal, i);
  m.trans = load1(p.trans, i);
  m.ior = load1(p.ior, i);
  m.coat = load1(p.coat, i);
  m.coat_rough = load1(p.coat_rough, i);
  m.flags = p.flags[i * p.flags_s];
  const float aniso =
      (m.flags & kMatAniso) != 0 ? load1(p.aniso, i) : 0.f;
  m.an = fabsf(aniso);
  // ggx.alpha_from_roughness(roughness, anisotropy)
  const float a = m.rough * m.rough;
  const float aspect = sqrtf(1.f - 0.9f * aniso);
  m.alpha.x = a / aspect;
  m.alpha.y = a * aspect;
  const float ca = m.coat_rough * m.coat_rough;
  m.coat_alpha.x = ca;
  m.coat_alpha.y = ca;
  m.cos_a = 1.f;
  m.sin_a = 0.f;
  if (p.mode & kAniso) {
    const float rot =
        ((m.flags & kMatAniso) != 0 ? load1(p.rot, i) : 0.f) * kTwoPi;
    m.cos_a = cosf(rot);
    m.sin_a = sinf(rot);
  }
  m.mat = 0;
  m.avg0 = m.avg1 = 0.f;
  if (p.mode & kRows) {
    m.mat = p.mat[i * p.mat_s];
    const float* av = p.avg.p + i * p.avg.s;
    m.avg0 = av[0];
    m.avg1 = av[p.avg.c];
  }
  return m;
}

__device__ __forceinline__ bool is_smooth(A2 a) {
  return a.x < kSmoothAlpha && a.y < kSmoothAlpha;
}

// frame rotation about z (bsdf._rotate_xy)
__device__ __forceinline__ V3 rotate_xy(V3 v, float c, float s) {
  return v3(v.x * c - v.y * s, v.x * s + v.y * c, v.z);
}

// ---------------------------------------------------------------------------
// Energy terms: the per-material rows or the LUTs
// ---------------------------------------------------------------------------

// column `col` of bsdf._energy_row at `cos`
__device__ float energy_row(const Params& p, const Mat& m, float cos,
                            int col) {
  const int k = p.energy_k;
  const float x = clamp_to(cos * (float)k - 0.5f, 0.f, (float)k - 1.f);
  const float x0 = floorf(x);
  const float f = x - x0;
  long long lin = (long long)m.mat * k +
                  (x0 >= 0.f && x0 <= (float)(k - 1) ? (long long)x0 : 0);
  lin = lin < 0 ? 0 : (lin > p.energy_rows - 1 ? p.energy_rows - 1 : lin);
  const long long lin1 = min(lin + 1, (long long)p.energy_rows - 1);
  return tap(p.energy, (int)(lin * 6 + col)) * (1.f - f) +
         tap(p.energy, (int)(lin1 * 6 + col)) * f;
}

__device__ __forceinline__ float ior_param(float ior) {
  return (ior - 1.f) / at_least(ior, 1e-6f);
}

// bsdf._sample_E
__device__ float sample_E(const Params& p, const Mat& m, float cos,
                          float rough) {
  const float e = sample2d(p.lut[kE], cos, rough);
  if ((p.mode & kAniso) && m.an > 0.f)
    return sample3d(p.lut[kEAniso], cos, rough, m.an);
  return e;
}

// bsdf._conductor_multiscatter's brdf_ms and e_avg
struct Ms {
  float brdf, e_avg;
};

__device__ Ms conductor_ms(const Params& p, const Mat& m, float wo_z,
                           float wi_z) {
  const float s = sgn(wo_z);
  wo_z = wo_z * s;
  wi_z = wi_z * s;
  float e_wo, e_wi, e_avg;
  if (p.mode & kRows) {
    e_wo = energy_row(p, m, wo_z, 0);
    e_wi = energy_row(p, m, wi_z, 0);
    e_avg = m.avg0;
  } else {
    e_wo = sample_E(p, m, wo_z, m.rough);
    e_wi = sample_E(p, m, wi_z, m.rough);
    e_avg = sample1d(p.lut[kEAvg], m.rough);
    if ((p.mode & kAniso) && m.an > 0.f)
      e_avg = sample2d(p.lut[kEAvgAniso], m.an, m.rough);
  }
  Ms r;
  r.brdf = (1.f - e_wo) * (1.f - e_wi) / (kPi * at_least(1.f - e_avg, 1e-5f));
  r.e_avg = e_avg;
  return r;
}

// the lobe for one f_avg component
__device__ __forceinline__ float ms_term(const Ms& ms, float f_avg) {
  const float fresnel_ms = f_avg * f_avg * ms.e_avg /
                           at_least(1.f - f_avg * (1.f - ms.e_avg), 1e-5f);
  return fresnel_ms * ms.brdf;
}

// bsdf._transparent_multiscatter
__device__ float transparent_ms(const Params& p, const Mat& m, float wo_z,
                                float ior, bool thin) {
  const bool into = ior >= 1.f;
  const float c = fabsf(wo_z);
  float e_wo;
  if (p.mode & kRows) {
    e_wo = energy_row(p, m, c, thin ? 0 : (into ? 2 : 3));
  } else if (thin) {
    e_wo = sample_E(p, m, c, m.rough);
  } else {
    e_wo = into ? sample3d(p.lut[kETransIn], c, m.rough, ior_param(ior))
                : sample3d(p.lut[kETransOut], c, m.rough, 1.f - ior);
  }
  return 1.f / at_least(e_wo, 1e-3f);
}

// bsdf._coat_fbar
__device__ float coat_fbar(const Params& p, const Mat& m, float wo_z,
                           bool coat_smooth) {
  const float c = fabsf(wo_z);
  if (coat_smooth) return fresnel_dielectric(c, kCoatIor);
  if (p.mode & kRows) return energy_row(p, m, c, 4);
  return sample2d(p.lut[kFCoatAvg], c, m.coat_rough);
}

// bsdf._coat_multiscatter
__device__ float coat_ms(const Params& p, const Mat& m, float wo_z) {
  const float c = fabsf(wo_z);
  float f_avg, e_f;
  if (p.mode & kRows) {
    f_avg = energy_row(p, m, c, 4);
    e_f = energy_row(p, m, c, 5);
  } else {
    f_avg = sample2d(p.lut[kFCoatAvg], c, m.coat_rough);
    e_f = sample2d(p.lut[kEFCoat], c, m.coat_rough);
  }
  return f_avg / at_least(e_f, 1e-4f);
}

// bsdf._diffuse_factor
__device__ float diffuse_factor(const Params& p, const Mat& m, float wo_z,
                                float wi_z) {
  const float s = sgn(wo_z);
  wo_z = wo_z * s;
  wi_z = wi_z * s;
  float e_wo, e_wi, e_avg;
  if (p.mode & kRows) {
    e_wo = energy_row(p, m, wo_z, 1);
    e_wi = energy_row(p, m, wi_z, 1);
    e_avg = m.avg1;
  } else {
    const float q = ior_param(m.ior);
    if ((p.mode & kAniso) && m.an > 0.f) {
      e_wo = sample4d(p.lut[kEMsAniso], wo_z, m.rough, q, m.an);
      e_wi = sample4d(p.lut[kEMsAniso], wi_z, m.rough, q, m.an);
      e_avg = sample3d(p.lut[kEMsAvgAniso], q, m.rough, m.an);
    } else {
      e_wo = sample3d(p.lut[kEMs], wo_z, m.rough, q);
      e_wi = sample3d(p.lut[kEMs], wi_z, m.rough, q);
      e_avg = sample2d(p.lut[kEMsAvg], q, m.rough);
    }
  }
  return (1.f - e_wo) * (1.f - e_wi) / (kPi * at_least(1.f - e_avg, 1e-5f));
}

// bsdf._opaque_dielectric_factor
__device__ float opaque_dielectric_factor(const Params& p, const Mat& m,
                                          float wo_z, float f_avg) {
  wo_z = fabsf(wo_z);
  float e_wo, e_ms_wo;
  if (p.mode & kRows) {
    e_wo = energy_row(p, m, wo_z, 0);
    e_ms_wo = energy_row(p, m, wo_z, 1);
  } else {
    const float q = ior_param(m.ior);
    e_wo = sample_E(p, m, wo_z, m.rough);
    e_ms_wo = ((p.mode & kAniso) && m.an > 0.f)
                  ? sample4d(p.lut[kEMsAniso], wo_z, m.rough, q, m.an)
                  : sample3d(p.lut[kEMs], wo_z, m.rough, q);
  }
  const float fresnel_ms =
      f_avg * f_avg * e_wo / at_least(1.f - f_avg * (1.f - e_wo), 1e-5f);
  return clamp_to(f_avg * e_ms_wo + fresnel_ms * (1.f - e_ms_wo), 0.f,
                  0.999f);
}

// ---------------------------------------------------------------------------
// bsdf.evaluate
// ---------------------------------------------------------------------------

__device__ void evaluate(const Params& p, const Mat& m, V3 wo, V3 wi,
                         float f[3], float& pdf) {
  const int mode = p.mode;
  if (mode & kAniso) {
    wo = rotate_xy(wo, m.cos_a, -m.sin_a);
    wi = rotate_xy(wi, m.cos_a, -m.sin_a);
  }
  f[0] = f[1] = f[2] = 0.f;
  pdf = 0.f;
  // reflection-hemisphere gate (bsdf.metal:200-201)
  if (!(wo.z >= kMinCos && wi.z >= kMinCos)) return;
  const bool smooth = (mode & kSmooth) && is_smooth(m.alpha);
  const float mm = m.metal;
  const float transparent = (1.f - mm) * m.trans;
  const float opaque = (1.f - mm) * (1.f - transparent);

  V3 wm = v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z);
  const float wm_len = norm3(wm);
  const float l = at_least(wm_len, 1e-20f);
  wm = v3(wm.x / l, wm.y / l, wm.z / l);
  wm = scale(wm, wm.z < 0.f ? -1.f : 1.f);
  const bool wm_ok = wm_len > 1e-10f;
  const float dot_wo_wm = fabsf(dot3(wo, wm));
  const float ss = single_scatter_brdf(m.alpha, wo, wi, wm);
  const float gpdf = ggx_pdf(m.alpha, wo, wm);

  if ((mode & kMetallic) && mm > 0.f && !smooth && wm_ok) {
    float fm[3];
    for (int c = 0; c < 3; ++c) fm[c] = schlick(m.albedo[c], dot_wo_wm) * ss;
    if (mode & kMultiscatter) {
      const Ms ms = conductor_ms(p, m, wo.z, wi.z);
      for (int c = 0; c < 3; ++c)
        fm[c] = fm[c] + ms_term(ms, avg_conductor_fresnel(m.albedo[c]));
    }
    for (int c = 0; c < 3; ++c) f[c] = f[c] + fm[c] * mm;
    pdf = pdf + gpdf * mm;
  }

  if ((mode & kTransparent) && transparent > 0.f && !smooth && wm_ok) {
    const float f_ss_t = fresnel_dielectric(dot3(wo, wm), m.ior);
    float ft = f_ss_t * ss;
    if (mode & kMultiscatter)
      ft = ft * transparent_ms(p, m, wo.z, m.ior,
                               (mode & kThin) && (m.flags & kMatThin));
    for (int c = 0; c < 3; ++c) f[c] = f[c] + ft * transparent;
    pdf = pdf + f_ss_t * gpdf * transparent;
  }

  if (opaque > 0.f) {
    const float f_avg = avg_dielectric_fresnel_fit(m.ior);
    const float bf = opaque_dielectric_factor(p, m, wo.z, f_avg);
    const float c_diffuse = diffuse_factor(p, m, wo.z, wi.z);
    const float diffuse_pdf = fabsf(wi.z) / kPi;
    float fo[3], pdf_o;
    if (smooth) {
      for (int c = 0; c < 3; ++c) fo[c] = m.albedo[c] * c_diffuse;
      pdf_o = diffuse_pdf * (1.f - bf);
    } else {
      float diel = fresnel_dielectric(dot_wo_wm, m.ior) * ss;
      if (mode & kMultiscatter)
        diel = diel + ms_term(conductor_ms(p, m, wo.z, wi.z), f_avg);
      for (int c = 0; c < 3; ++c) fo[c] = diel + m.albedo[c] * c_diffuse;
      pdf_o = gpdf * bf + diffuse_pdf * (1.f - bf);
    }
    for (int c = 0; c < 3; ++c) f[c] = f[c] + fo[c] * opaque;
    pdf = pdf + pdf_o * opaque;
  }

  if (mode & kClearcoat) {
    const bool coat_smooth = is_smooth(m.coat_alpha);
    // base dimming by the coat's marginal pick probability c * Fbar(wo)
    const float coat_dim = m.coat * coat_fbar(p, m, wo.z, coat_smooth);
    const float coat_add =
        m.coat * ((coat_smooth || !wm_ok)
                      ? 0.f
                      : fresnel_dielectric(dot3(wo, wm), kCoatIor));
    float add_f = 0.f, add_pdf = 0.f;
    if (coat_add > 0.f) {
      float coat_ss = single_scatter_brdf(m.coat_alpha, wo, wi, wm);
      if (mode & kMultiscatter) coat_ss = coat_ss * coat_ms(p, m, wo.z);
      add_f = coat_ss * coat_add;
      add_pdf = ggx_pdf(m.coat_alpha, wo, wm) * coat_add;
    }
    for (int c = 0; c < 3; ++c) f[c] = f[c] * (1.f - coat_dim) + add_f;
    pdf = pdf * (1.f - coat_dim) + add_pdf;
  }
}

// ---------------------------------------------------------------------------
// bsdf.sample
// ---------------------------------------------------------------------------

struct Sample {
  V3 wi;
  float f[3];
  float pdf;
  int flags;
};

__device__ __forceinline__ void fill(float f[3], float v) {
  f[0] = f[1] = f[2] = v;
}

__device__ Sample sample(const Params& p, const Mat& m, V3 wo_in,
                         const float r4[4], float rc0, float rc1) {
  const int mode = p.mode;
  V3 wo = wo_in;
  if (mode & kAniso) wo = rotate_xy(wo, m.cos_a, -m.sin_a);
  const bool smooth = (mode & kSmooth) && is_smooth(m.alpha);
  const bool thin = (mode & kThin) && (m.flags & kMatThin);
  const float mm = m.metal, t = m.trans, c = m.coat;

  // lobe-selection probabilities (bsdf.metal:229-252)
  float p_coat = 0.f;
  bool coat_smooth = false;
  V3 wm_coat = v3(0.f, 0.f, 1.f);
  if (mode & kClearcoat) {
    coat_smooth = is_smooth(m.coat_alpha);
    if (!coat_smooth) wm_coat = sample_vmdf(m.coat_alpha, wo, rc0, rc1);
    p_coat = c * fresnel_dielectric(fabsf(dot3(wo, wm_coat)), kCoatIor);
    p_coat = c > 0.f ? p_coat : 0.f;
  }
  const float p_metal = p_coat + (1.f - p_coat) * mm;
  const float p_transparent = p_coat + (1.f - p_coat) * (mm + (1.f - mm) * t);
  const float rw = r4[3];
  const bool sel_coat = (mode & kClearcoat) && rw < p_coat;
  const bool sel_metal = (mode & kMetallic) && !sel_coat && rw < p_metal;
  const bool sel_trans = (mode & kTransparent) && !sel_coat && !sel_metal &&
                         rw < p_transparent;
  const float u0 = r4[0], u1 = r4[1], rz = r4[2];
  const V3 mirror = v3(-wo.x, -wo.y, wo.z);
  const bool ms_on = (mode & kMultiscatter) != 0;

  Sample s;
  if (sel_coat) {
    const V3 wi_r = reflect3(neg(wo), wm_coat);
    const bool bad = wo.z * wi_r.z < 0.f;
    if (coat_smooth) {
      const float fs = fresnel_dielectric(wo.z, kCoatIor);
      s.wi = mirror;
      fill(s.f, fs / at_least(fabsf(wo.z), 1e-20f));
      s.pdf = fs;
      s.flags = kReflected | kSpecular;
    } else {
      s.wi = wi_r;
      if (bad) {
        fill(s.f, 0.f);
        s.pdf = 0.f;
      } else {
        const float f_ss = fresnel_dielectric(fabsf(dot3(wo, wm_coat)),
                                              kCoatIor);
        float fr = f_ss * single_scatter_brdf(m.coat_alpha, wo, wi_r, wm_coat);
        if (ms_on) fr = fr * coat_ms(p, m, wo.z);
        fill(s.f, fr);
        s.pdf = f_ss * ggx_pdf(m.coat_alpha, wo, wm_coat);
      }
      s.flags = kReflected | kGlossy;
    }
  } else if (sel_metal) {
    if (smooth) {
      s.wi = mirror;
      const float inv = at_least(fabsf(wo.z), 1e-20f);
      for (int k = 0; k < 3; ++k) s.f[k] = schlick(m.albedo[k], wo.z) / inv;
      s.pdf = 1.f;
      s.flags = kReflected | kSpecular;
    } else {
      const V3 wm = sample_vmdf(m.alpha, wo, u0, u1);
      const V3 wi_r = reflect3(neg(wo), wm);
      s.wi = wi_r;
      if (wo.z * wi_r.z < 0.f) {
        fill(s.f, 0.f);
        s.pdf = 0.f;
      } else {
        const float d = fabsf(dot3(wo, wm));
        const float ss = single_scatter_brdf(m.alpha, wo, wi_r, wm);
        for (int k = 0; k < 3; ++k) s.f[k] = schlick(m.albedo[k], d) * ss;
        if (ms_on) {
          const Ms ms = conductor_ms(p, m, wo.z, wi_r.z);
          for (int k = 0; k < 3; ++k)
            s.f[k] = s.f[k] + ms_term(ms, avg_conductor_fresnel(m.albedo[k]));
        }
        s.pdf = ggx_pdf(m.alpha, wo, wm);
      }
      s.flags = kReflected | kGlossy;
    }
  } else if (sel_trans) {
    const float ior_t = (wo.z < 0.f && !thin) ? 1.f / m.ior : m.ior;
    if (smooth) {
      // bsdf.metal:586-617
      const float f_ss = fresnel_dielectric(fabsf(wo.z), ior_t);
      const bool refl = rz < f_ss;
      V3 wi;
      if (refl)
        wi = mirror;
      else if (thin)
        wi = neg(wo);
      else
        wi = refract3(neg(wo), v3(0.f, 0.f, sgn(wo.z)), 1.f / ior_t);
      const bool bad = !refl && fabsf(wi.z) < 1e-9f;
      const float pdf_s = refl ? f_ss : 1.f - f_ss;
      const float f_s = pdf_s / at_least(fabsf(wi.z), 1e-20f);
      s.wi = wi;
      for (int k = 0; k < 3; ++k)
        s.f[k] = bad ? 0.f : f_s * (refl ? 1.f : m.albedo[k]);
      s.pdf = bad ? 0.f : pdf_s;
      s.flags = (refl ? kReflected : kTransmitted) | kSpecular;
    } else {
      const V3 wm = sample_vmdf(m.alpha, wo, u0, u1);
      const float dot_wo_wm = dot3(wo, wm);
      const float f_ss = fresnel_dielectric(fabsf(dot_wo_wm), ior_t);
      const bool refl = rz < f_ss;
      const V3 wi_refl = reflect3(neg(wo), wm);
      V3 wi;
      if (refl)
        wi = wi_refl;
      else if (thin)
        wi = v3(wi_refl.x * 1.f, wi_refl.y * 1.f, wi_refl.z * -1.f);
      else
        wi = refract3(neg(wo), scale(wm, dot_wo_wm < 0.f ? -1.f : 1.f),
                      1.f / ior_t);
      const bool same_side = wo.z * wi.z > 0.f;
      const bool bad = refl ? !same_side : same_side;
      s.wi = wi;
      if (bad) {
        fill(s.f, 0.f);
        s.pdf = 0.f;
      } else {
        const float k = refl ? f_ss : 1.f - f_ss;
        float base, pdf_b;
        if (refl || thin) {
          base = single_scatter_brdf(m.alpha, wo, wi, wm);
          pdf_b = ggx_pdf(m.alpha, wo, wm);
        } else {
          const float dot_i = dot3(wi, wm);
          float denom = dot_i * ior_t + dot_wo_wm;
          denom = denom * denom;
          const float dwm_dwi = fabsf(dot_i) / at_least(denom, 1e-20f);
          base = mdf(m.alpha, wm) * g2(m.alpha, wo, wi) *
                 fabsf(dot_i * dot_wo_wm /
                       (wi.z * wo.z * at_least(denom, 1e-20f)));
          pdf_b = vmdf(m.alpha, wo, wm) * dwm_dwi;
        }
        float fr = k * base;
        if (ms_on) fr = fr * transparent_ms(p, m, wo.z, ior_t, thin);
        for (int j = 0; j < 3; ++j) s.f[j] = fr * (refl ? 1.f : m.albedo[j]);
        s.pdf = k * pdf_b;
      }
      s.flags = (refl ? kReflected : kTransmitted) | kGlossy;
    }
  } else {
    // opaque dielectric
    const float f_avg = avg_dielectric_fresnel_fit(m.ior);
    const float bf = opaque_dielectric_factor(p, m, wo.z, f_avg);
    if (rz < bf) {
      if (smooth) {
        const float f_ss = fresnel_dielectric(fabsf(wo.z), m.ior);
        s.wi = mirror;
        fill(s.f, f_ss / at_least(fabsf(wo.z), 1e-20f));
        s.pdf = bf;
        s.flags = kReflected | kSpecular;
      } else {
        const V3 wm = sample_vmdf(m.alpha, wo, u0, u1);
        const V3 wi_r = reflect3(neg(wo), wm);
        s.wi = wi_r;
        if (dot3(wm, wm) < 1e-12f) {
          fill(s.f, 0.f);
          s.pdf = 0.f;
        } else {
          const float f_ss = fresnel_dielectric(fabsf(dot3(wo, wm)), m.ior);
          float diel = f_ss * single_scatter_brdf(m.alpha, wo, wi_r, wm);
          if (ms_on)
            diel = diel + ms_term(conductor_ms(p, m, wo.z, wi_r.z), f_avg);
          fill(s.f, diel);
          s.pdf = ggx_pdf(m.alpha, wo, wm) * bf;
        }
        s.flags = kReflected | kGlossy;
      }
    } else {
      // diffuse sub-lobe: samplers.sample_cosine_hemisphere
      const float phi = u0 * 2.f * kPi;
      const float st = sqrtf(u1);
      const float ct = sqrtf(at_least(1.f - u1, 0.f));
      const float sw = wo.z < 0.f ? -1.f : 1.f;
      const V3 wi = v3(cosf(phi) * st * sw, sinf(phi) * st * sw, ct * sw);
      const float c_diffuse = diffuse_factor(p, m, wo.z, wi.z);
      s.wi = wi;
      for (int k = 0; k < 3; ++k) s.f[k] = m.albedo[k] * c_diffuse;
      s.pdf = fabsf(wi.z) / kPi * (1.f - bf);
      s.flags = kReflected | kDiffuse |
                ((m.flags & kMatEmissive) != 0 ? kEmitted : 0);
    }
  }

  // zero-pdf lanes are dead samples
  const bool dead = s.pdf <= 0.f;
  if (dead) {
    s.flags = 0;
    fill(s.f, 0.f);
  }
  if (mode & kAniso) s.wi = rotate_xy(s.wi, m.cos_a, m.sin_a);
  if ((mode & kMixturePdf) && !dead && (s.flags & kSpecular) == 0 &&
      !(wo_in.z * s.wi.z <= 0.f)) {
    float ev_f[3], ev_pdf;
    evaluate(p, m, wo_in, s.wi, ev_f, ev_pdf);
    if (!(ev_pdf <= 0.f)) {
      for (int k = 0; k < 3; ++k) s.f[k] = ev_f[k];
      s.pdf = ev_pdf;
    }
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    bsdf_sample_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const Mat m = load_mat(p, i);
  const V3 wo = load3(p.wo, i);
  const float* r = p.a.p + i * p.a.s;
  const float r4[4] = {r[0], r[p.a.c], r[2 * p.a.c], r[3 * p.a.c]};
  const float* q = p.b.p + i * p.b.s;
  const Sample s = sample(p, m, wo, r4, q[0], q[p.b.c]);
  p.o_wi[3 * i] = s.wi.x;
  p.o_wi[3 * i + 1] = s.wi.y;
  p.o_wi[3 * i + 2] = s.wi.z;
  p.o_f[3 * i] = s.f[0];
  p.o_f[3 * i + 1] = s.f[1];
  p.o_f[3 * i + 2] = s.f[2];
  p.o_pdf[i] = s.pdf;
  p.o_flags[i] = s.flags;
}

__global__ void __launch_bounds__(kThreads)
    bsdf_evaluate_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const Mat m = load_mat(p, i);
  float f[3], pdf;
  evaluate(p, m, load3(p.wo, i), load3(p.a, i), f, pdf);
  p.o_f[3 * i] = f[0];
  p.o_f[3 * i + 1] = f[1];
  p.o_f[3 * i + 2] = f[2];
  p.o_pdf[i] = pdf;
}

// The argument list of `bsdf_shade_launch`, in int64 words: per field
// (pointer, lane stride, component stride); per LUT (pointer, 4 dims).
constexpr int kFieldWords = 3;
constexpr int kArgWords = 15 * kFieldWords  // fields, flags, mat, wo, a, b
                          + 3               // energy pointer, K, rows
                          + kNumLuts * 5    // LUTs
                          + 4;              // outputs

Col take_col(const long long*& w) {
  Col c;
  c.p = reinterpret_cast<const float*>(w[0]);
  c.s = w[1];
  c.c = w[2];
  w += kFieldWords;
  return c;
}

}  // namespace

extern "C" {

// Launches one BSDF pass over n lanes on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a wrong
// argument count or entry). entry 0 samples (outputs wi (n, 3), f (n, 3),
// pdf (n,), flags (n,) i32), entry 1 evaluates (outputs f, pdf; the wi and
// flags words are 0). `args` holds n_args int64 words, in order: albedo,
// roughness, metallic, transmission, ior, anisotropy, anisotropy_rotation,
// clearcoat, clearcoat_roughness, energy_avg_row, flags (i32), mat_idx
// (i32), wo, then r4 and rc (sample) or wi and
// an unused field (evaluate), each as (pointer, lane stride, component
// stride) in elements; the energy rows (pointer to (rows, 6) f32, K,
// rows); the 14 LUTs of bsdf's Luts in field order as (pointer, dims);
// the output pointers. Allocates nothing and does not synchronise.
int bsdf_shade_launch(int entry, int n, int mode, const long long* args,
                      int n_args, void* cuda_stream) {
  if (n_args != kArgWords || (entry != 0 && entry != 1))
    return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Params p;
  p.n = n;
  p.mode = mode;
  const long long* w = args;
  p.albedo = take_col(w);
  p.rough = take_col(w);
  p.metal = take_col(w);
  p.trans = take_col(w);
  p.ior = take_col(w);
  p.aniso = take_col(w);
  p.rot = take_col(w);
  p.coat = take_col(w);
  p.coat_rough = take_col(w);
  p.avg = take_col(w);
  p.flags = reinterpret_cast<const int*>(w[0]);
  p.flags_s = w[1];
  w += kFieldWords;
  p.mat = reinterpret_cast<const int*>(w[0]);
  p.mat_s = w[1];
  w += kFieldWords;
  p.wo = take_col(w);
  p.a = take_col(w);
  p.b = take_col(w);
  p.energy = reinterpret_cast<const float*>(w[0]);
  p.energy_k = (int)w[1];
  p.energy_rows = (int)w[2];
  w += 3;
  for (int k = 0; k < kNumLuts; ++k) {
    p.lut[k].p = reinterpret_cast<const float*>(w[0]);
    for (int d = 0; d < 4; ++d) p.lut[k].n[d] = (int)w[1 + d];
    w += 5;
  }
  p.o_wi = reinterpret_cast<float*>(w[0]);
  p.o_f = reinterpret_cast<float*>(w[1]);
  p.o_pdf = reinterpret_cast<float*>(w[2]);
  p.o_flags = reinterpret_cast<int*>(w[3]);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (entry == 0)
    bsdf_sample_kernel<<<grid, kThreads, 0, stream>>>(p);
  else
    bsdf_evaluate_kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

const char* bsdf_shade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
