// The hit fetch of render/integrator.py's shaded bounce in one pass per
// lane, on Hopper (sm_90a): `hit_fetch_kernel` reads a lane's hit record,
// its triangle's shading and geometry rows and its material's rows, and
// writes what ops/hitdata.py `interpolate_hit` and the row reads of
// models/bsdf.py `make_shading_context` give (ops/hitdata.py `fetch_hit`).
//
// It replaces no TPU kernel: on the TPU the same code is plain JAX, its
// row reads where-chains or one-hot matmuls (platinum_tpu/ops/hitdata.py,
// lookup.py). It was added because the port ran it as four PyTorch row
// gathers (`table[idx]`: one block of one warp per lane, 3-6 threads of
// it loading) and some forty strided elementwise operations a bounce;
// the plain code (`interpolate_hit` and `lookup.rows`) stays as the
// reference the tests hold this to and as the CPU path.
//
// What it computes is the plain code's function, on world-space geometry
// or, on the two-level path, on the object-space mesh library with each
// lane's instance row: a miss reads triangle row 0 (and instance 0); uv,
// the shading normal (the barycentric blend of the vertex normals), the
// tangent and the geometric normal (the edges' cross product), each
// normalised as frame.normalize does, and on the two-level path carried
// to world space (the normals by the instance's normal matrix, the
// tangent by its linear part) and normalised again; the material index
// (the geometry row's float, truncated; on the two-level path a material
// slot, clamped to the instance's slots and resolved through its row of
// the slot table); the hit point o + d * t formed in float64 and rounded
// once; the frame of frame.from_nt with its degenerate-tangent fallback;
// the outgoing direction in it. Each value is formed by the plain code's
// operations in its order, one rounding each: the source is built with
// -fmad=false and division and square root are IEEE. So uv and the hit
// point are the plain code's bits; the normalised vectors differ from it
// by the order of a three-term sum, an ulp or so. The material rows, the
// energy-average row and the atlas entries are copies. As the plain
// code's row reads ask, every material index lies in the material table:
// the kernel reads the row it names and does not check it.
//
// What bounds it on the card: bytes and latency. A lane reads 41 B of
// hit record and ray, then its two triangle rows (80 + 48 B used of 96 +
// 48 B; on the two-level path its instance's row, 80 B used of 96, in the
// same round), then its material's rows (64 + 16 + 24 B; a handful of
// rows, cached), and writes 164 B. Each row arrives as 16-byte loads
// (8-byte for the atlas entries) issued together, so a row's latency is
// paid once a round, and the two rounds (triangle, then material; the
// slot table's float between them on the two-level path) are the chain
// a lane cannot shorten. Inputs are read where they lie (each field
// by pointer, lane stride and component stride); nothing is allocated,
// nothing synchronised.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShade = 24;  // tri_shade row: n0 n1 n2, tangent4, uv0-2
constexpr int kGeo = 12;    // tri_geo row: v0, e1, e2, material, node, pad
constexpr int kInst = 24;   // instances.rows row: A, normal matrix, node, pad

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
// torch.sum(a * b, -1): the products, then summed in order
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
}
// frame.normalize
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float l = at_least(sqrtf(dot3(a, a)), 1e-20f);
  return v3(a.x / l, a.y / l, a.z / l);
}
// frame.cross
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// m v for a row-major 3x3 m (the einsum of ops/hitdata.py), each row's
// products summed in order
__device__ __forceinline__ V3 mul3(const float* m, V3 a) {
  return v3((m[0] * a.x + m[1] * a.y) + m[2] * a.z,
            (m[3] * a.x + m[4] * a.y) + m[5] * a.z,
            (m[6] * a.x + m[7] * a.y) + m[8] * a.z);
}
// a * w + b * u + c * v, left to right, as hitdata's blends are written
__device__ __forceinline__ float blend(float a, float b, float c, float w,
                                       float u, float v) {
  return (a * w + b * u) + c * v;
}

// A per-lane field: element [lane * s + k * c]
struct Col {
  const void* p;
  long long s, c;
};

struct Params {
  int n;
  Col tri, hit, t, bary, o, d;
  Col inst;              // i32; read only with `irows`
  const float4* shade;   // (T, 24) f32, 16-byte aligned rows
  const float4* geo;     // (T, 12)
  const float4* mat;     // (M, 16)
  const float4* avg;     // (M, 4) or null
  const int2* tex;       // (M, 6) i32 or null
  const float4* irows;   // (I, 24), or null on world-space geometry
  const float* slot_mat; // (I, S) material row per (instance, slot)
  int n_slots;           // S
  float* o_pos;
  float* o_normal;
  float* o_gnormal;
  float* o_uv;
  float* o_wo;
  float* o_ft;
  float* o_fb;
  int* o_mat_idx;
  float4* o_mat;         // (n, 16)
  float4* o_avg;         // (n, 4) or null
  int2* o_tex;           // (n, 6) or null
};

template <class T>
__device__ __forceinline__ T field(const Col& c, long long i, int k = 0) {
  return static_cast<const T*>(c.p)[i * c.s + k * c.c];
}
__device__ __forceinline__ V3 field3(const Col& c, long long i) {
  return v3(field<float>(c, i), field<float>(c, i, 1), field<float>(c, i, 2));
}
__device__ __forceinline__ void store3(float* out, long long i, V3 a) {
  out[3 * i] = a.x;
  out[3 * i + 1] = a.y;
  out[3 * i + 2] = a.z;
}

// kTwoLevel: the two-level path (`irows` set); its own instantiation, so
// that world-space geometry keeps the registers it had without it
template <bool kTwoLevel>
__global__ void __launch_bounds__(kThreads) hit_fetch_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const bool hit = field<unsigned char>(p.hit, i) != 0;
  const long long tri = hit ? field<int>(p.tri, i) : 0;  // misses: row 0
  // the triangle's rows, every load issued before any is used: shade's
  // first five quads (floats 0-19), geo's three; on the two-level path
  // the instance's first five (A, the normal matrix: floats 0-17)
  const float4* sp = p.shade + tri * (kShade / 4);
  const float4* gp = p.geo + tri * (kGeo / 4);
  float4 s[5], g[3], q[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) s[k] = __ldg(sp + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = __ldg(gp + k);
  const long long inst = kTwoLevel && hit ? field<int>(p.inst, i) : 0;
  if (kTwoLevel) {
    const float4* ip = p.irows + inst * (kInst / 4);
#pragma unroll
    for (int k = 0; k < 5; ++k) q[k] = __ldg(ip + k);
  }
  const float u = field<float>(p.bary, i);
  const float v = field<float>(p.bary, i, 1);
  const float t = hit ? field<float>(p.t, i) : 0.f;
  const V3 o = field3(p.o, i);
  const V3 d = field3(p.d, i);

  // the material index first, so its rows load while the frame is formed;
  // on the two-level path the row holds the instance's slot
  int mat_idx = (int)g[2].y;
  if (kTwoLevel) {
    const int slot = mat_idx < 0 ? 0
                                 : (mat_idx >= p.n_slots ? p.n_slots - 1
                                                         : mat_idx);
    mat_idx = (int)__ldg(p.slot_mat + inst * p.n_slots + slot);
  }
  float4 mrow[4], arow;
  int2 trow[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    mrow[k] = __ldg(p.mat + (long long)mat_idx * 4 + k);
  }
  if (p.avg) arow = __ldg(p.avg + mat_idx);
  if (p.tex) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      trow[k] = __ldg(p.tex + (long long)mat_idx * 3 + k);
    }
  }

  // shade: n0 = s0.xyz, n1 = (s0.w, s1.x, s1.y), n2 = (s1.z, s1.w, s2.x),
  // tangent4 = (s2.y, s2.z, s2.w, s3.x), uv0 = s3.yz, uv1 = (s3.w, s4.x),
  // uv2 = s4.yz; geo: e1 = (g0.w, g1.x, g1.y), e2 = (g1.z, g1.w, g2.x)
  const float w = (1.f - u) - v;
  const float uv0 = blend(s[3].y, s[3].w, s[4].y, w, u, v);
  const float uv1 = blend(s[3].z, s[4].x, s[4].z, w, u, v);
  V3 normal = normalize3(v3(blend(s[0].x, s[0].w, s[1].z, w, u, v),
                            blend(s[0].y, s[1].x, s[1].w, w, u, v),
                            blend(s[0].z, s[1].y, s[2].x, w, u, v)));
  V3 tangent = normalize3(v3(s[2].y, s[2].z, s[2].w));
  const float sign = s[3].x;
  V3 gnormal = normalize3(
      cross3(v3(g[0].w, g[1].x, g[1].y), v3(g[1].z, g[1].w, g[2].x)));
  if (kTwoLevel) {
    // to world space: A = floats 0-8 of the instance row, the normal
    // matrix 9-17
    const float a[9] = {q[0].x, q[0].y, q[0].z, q[0].w, q[1].x,
                        q[1].y, q[1].z, q[1].w, q[2].x};
    const float nm[9] = {q[2].y, q[2].z, q[2].w, q[3].x, q[3].y,
                         q[3].z, q[3].w, q[4].x, q[4].y};
    normal = normalize3(mul3(nm, normal));
    gnormal = normalize3(mul3(nm, gnormal));
    tangent = normalize3(mul3(a, tangent));
  }

  // ops/hitdata.py: o + d * t in float64, rounded once
  const V3 pos = v3((float)((double)o.x + (double)d.x * (double)t),
                    (float)((double)o.y + (double)d.y * (double)t),
                    (float)((double)o.z + (double)d.z * (double)t));

  // frame.from_nt, with frame.from_normal where the tangent is degenerate
  V3 ft, fb;
  if (fabsf(dot3(normal, tangent)) > 0.9f) {
    const V3 a = fabsf(normal.x) > 0.5f ? v3(0.f, 0.f, 1.f)
                                        : v3(1.f, 0.f, 0.f);
    fb = normalize3(cross3(normal, a));
    ft = cross3(normal, fb);
  } else {
    const V3 b = normalize3(cross3(normal, tangent));
    fb = v3(b.x * sign, b.y * sign, b.z * sign);
    ft = cross3(fb, normal);
  }
  // frame.world_to_local(frame, -d)
  const V3 nd = v3(-d.x, -d.y, -d.z);
  const V3 wo = v3(dot3(nd, ft), dot3(nd, fb), dot3(nd, normal));

  store3(p.o_pos, i, pos);
  store3(p.o_normal, i, normal);
  store3(p.o_gnormal, i, gnormal);
  p.o_uv[2 * i] = uv0;
  p.o_uv[2 * i + 1] = uv1;
  store3(p.o_wo, i, wo);
  store3(p.o_ft, i, ft);
  store3(p.o_fb, i, fb);
  p.o_mat_idx[i] = mat_idx;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.o_mat[4 * i + k] = mrow[k];
  if (p.o_avg) p.o_avg[i] = arow;
  if (p.o_tex) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.o_tex[3 * i + k] = trow[k];
  }
}

// The argument list of `hit_fetch_launch`, in int64 words
constexpr int kFieldWords = 3;
constexpr int kArgWords = 7 * kFieldWords  // tri, hit, t, bary, o, d, inst
                          + 8              // tables, slot count
                          + 11;            // outputs

Col take_col(const long long*& w) {
  Col c;
  c.p = reinterpret_cast<const void*>(w[0]);
  c.s = w[1];
  c.c = w[2];
  w += kFieldWords;
  return c;
}

}  // namespace

extern "C" {

// Launches one hit fetch over n lanes on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a wrong
// argument count, or an instance table without slots). `args` holds
// n_args int64 words, in order: the lane fields tri (i32), hit (bool as
// u8), t, bary, o, d, inst (i32; zeros on world-space geometry), each as
// (pointer, lane stride, component stride) in elements; the tables
// tri_shade (T, 24), tri_geo (T, 12), materials.packed (M, 16),
// materials.energy_avg (M, 4) or 0, materials.textures (M, 6) i32 or 0,
// instances.rows (I, 24) or 0 (world-space geometry), instances.slot_mat
// (I, S) or 0, and S; the outputs pos, normal, gnormal (n, 3), uv (n, 2),
// wo, frame_t, frame_b (n, 3), mat_idx (n,) i32, the material rows
// (n, 16), the energy-average rows (n, 4) or 0, the atlas entries (n, 6)
// i32 or 0, each contiguous. The float tables (the slot table aside)
// and the row outputs are 16-byte aligned, the atlas entries 8-byte.
// Allocates nothing and does not synchronise.
int hit_fetch_launch(int n, const long long* args, int n_args,
                     void* cuda_stream) {
  if (n_args != kArgWords) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Params p;
  p.n = n;
  const long long* w = args;
  p.tri = take_col(w);
  p.hit = take_col(w);
  p.t = take_col(w);
  p.bary = take_col(w);
  p.o = take_col(w);
  p.d = take_col(w);
  p.inst = take_col(w);
  p.shade = reinterpret_cast<const float4*>(w[0]);
  p.geo = reinterpret_cast<const float4*>(w[1]);
  p.mat = reinterpret_cast<const float4*>(w[2]);
  p.avg = reinterpret_cast<const float4*>(w[3]);
  p.tex = reinterpret_cast<const int2*>(w[4]);
  p.irows = reinterpret_cast<const float4*>(w[5]);
  p.slot_mat = reinterpret_cast<const float*>(w[6]);
  p.n_slots = (int)w[7];
  w += 8;
  if (p.irows && (!p.slot_mat || p.n_slots <= 0)) {
    return cudaErrorInvalidValue;
  }
  p.o_pos = reinterpret_cast<float*>(w[0]);
  p.o_normal = reinterpret_cast<float*>(w[1]);
  p.o_gnormal = reinterpret_cast<float*>(w[2]);
  p.o_uv = reinterpret_cast<float*>(w[3]);
  p.o_wo = reinterpret_cast<float*>(w[4]);
  p.o_ft = reinterpret_cast<float*>(w[5]);
  p.o_fb = reinterpret_cast<float*>(w[6]);
  p.o_mat_idx = reinterpret_cast<int*>(w[7]);
  p.o_mat = reinterpret_cast<float4*>(w[8]);
  p.o_avg = reinterpret_cast<float4*>(w[9]);
  p.o_tex = reinterpret_cast<int2*>(w[10]);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (p.irows) {
    hit_fetch_kernel<true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    hit_fetch_kernel<false><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

const char* hit_fetch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
