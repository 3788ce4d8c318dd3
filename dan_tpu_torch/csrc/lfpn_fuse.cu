// The LFPN's top-down fusion in one pass, for Hopper (sm_90a): the 2x
// bilinear upsample of the top-down map, its crop to the lateral map's size
// and its product (or sum) with the lateral map, in every inference forward
// on the card (models/lfpn.py).
//
//   td   (B, h, w, C) bf16 or float32, C fastest (channels-last), read only
//   lat  (B, H, W, C) td's dtype, H <= 2h and W <= 2w, read only
//   out  (B, H, W, C) td's dtype
//   up[n, y, x, c]  = round_T(ATen's upsample_bilinear2d of td, scale 2,
//                     half-pixel centres, at (y, x))
//   out[n, y, x, c] = round_T(float(up) (*|+) float(lat[n, y, x, c]))
//
// It replaces no Pallas kernel: XLA fuses jax.image.resize and the product
// on the TPU.  It replaces ATen's two passes, upsample_bilinear2d_nhwc (one
// thread a value, four scalar loads each) and the product of the cropped
// view with the lateral map; the upsampled map is never written.  Its
// arithmetic is that of ATen's channels-last kernel, operation by operation
// (`-fmad=false`, each product, FMA and sum by its intrinsic): the source
// index max(0.5 (dst + 0.5) - 0.5, 0), i1 = (int) index, i1p = i1 < size - 1,
// the lambdas as ATen forms them; the value
//   h0l * (w0l * x00 + w1l * x01) + h1l * (w0l * x10 + w1l * x11)
// in float32 with each sum contracted into an FMA as ATen's compiled kernel
// contracts it (dot2_* below), rounded to T; then the product or sum with the
// lateral value in float32, rounded to T once more.  The zero-weight terms
// stay, so a non-finite neighbour propagates as it does in ATen.
//
// What bounds it: bytes, td read once (a quarter of the output's values),
// lat read once and out written once.  A thread takes one 16-byte pack (8
// bf16 or 4 float32 channels) of a 2x2 quad of output pixels, rows 2i and
// 2i + 1, columns 2j and 2j + 1.  At scale 2 those rows read only source
// rows i - 1, i and i + 1 (clamped), as ATen's indices give them: row 2i
// reads (a0, a1), row 2i + 1 reads (b0, b1) with b0 = i, and a1 is b0 (i > 0)
// or b1 (i = 0).  So the quad's four outputs come from nine 16-byte loads of
// td, rows {a0, b0, b1} x columns {c0, d0, d1}, with a1 (and c1) chosen by a
// select: 2.25 loads an output pixel.  Each source row is interpolated
// along the row once for the left and once for the right output column (in
// bf16 the two output rows share row b0's; see dot2_upper).  Channel packs
// are the fastest index of the work, so a warp reads and writes consecutive
// 512-byte spans; td (a quarter of the bytes) is read again by the
// neighbouring quads from L1 and L2.  The grid has a thread for every (image,
// quad row, quad column, channel pack): on an H100 that ran at 89 % of the
// bytes' bound at the LFPN's shapes, where a persistent grid striding over
// the same items ran at 73 %, and L2 streaming hints on lat and out cost
// 3 %.  The quads that cross (H, W) store only their pixels inside.  C not a
// multiple of 16 bytes, or a pointer off 16 bytes, takes the same code one
// value a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// ATen's source scale for scale_factor 2: 1 / 2.
constexpr float kScale = 0.5f;

// A word: the values one conversion takes, two bf16 lanes of a 16-byte pack
// or one value.  A pack is the 16 bytes (or one value) of one pixel that a
// thread loads or stores at once.
template <typename T, int V>
struct Word {
  using type = T;
  static constexpr int kLanes = 1;
};
template <>
struct Word<__nv_bfloat16, 8> {
  using type = __nv_bfloat162;
  static constexpr int kLanes = 2;
};

// Widening bf16 is exact: its bits are the high half of the float's, as
// ATen's c10::BFloat16 widens them (two integer operations a word, where a
// conversion instruction runs at a quarter of their rate).
__device__ __forceinline__ void to_floats(float w, float (&f)[1]) { f[0] = w; }
__device__ __forceinline__ void to_floats(__nv_bfloat16 w, float (&f)[1]) {
  f[0] = __uint_as_float((uint32_t)__bfloat16_as_ushort(w) << 16);
}
__device__ __forceinline__ void to_floats(__nv_bfloat162 w, float (&f)[2]) {
  const uint32_t u = *reinterpret_cast<const uint32_t *>(&w);
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void from_floats(const float (&f)[1], float &w) { w = f[0]; }
__device__ __forceinline__ void from_floats(const float (&f)[1], __nv_bfloat16 &w) {
  w = __float2bfloat16_rn(f[0]);
}
__device__ __forceinline__ void from_floats(const float (&f)[2], __nv_bfloat162 &w) {
  w = __floats2bfloat162_rn(f[0], f[1]);
}
// f rounded to nearest even in W's type, lane by lane, and widened back.
template <typename W, int N>
__device__ __forceinline__ void round_as(float (&f)[N]) {
  W w;
  from_floats(f, w);
  to_floats(w, f);
}

template <typename T, int V>
struct Pack {
  static_assert(V == 1 || V * sizeof(T) == 16, "a pack is one value or 16 bytes");
  using W = typename Word<T, V>::type;
  static constexpr int kWords = V / Word<T, V>::kLanes;
  union {
    uint4 u;
    W w[kWords];
  };
  __device__ __forceinline__ void load(const T *p) {
    if constexpr (V == 1) {
      w[0] = *p;
    } else {
      u = *reinterpret_cast<const uint4 *>(p);
    }
  }
  __device__ __forceinline__ void load_ro(const T *p) {
    if constexpr (V == 1) {
      w[0] = __ldg(p);
    } else {
      u = __ldg(reinterpret_cast<const uint4 *>(p));
    }
  }
  __device__ __forceinline__ void store(T *p) const {
    if constexpr (V == 1) {
      *p = w[0];
    } else {
      *reinterpret_cast<uint4 *>(p) = u;
    }
  }
};

// w0 * x0 + w1 * x1 as ATen's compiled channels-last kernel rounds it, in
// the three sums of h0l * (w0l * x00 + w1l * x01) + h1l * (...): the upper
// row's sum contracts its second product into an FMA, the lower row's and
// the outer sum their first.  A bf16 value times a weight in {0, 1/4, 3/4,
// 1} is exact in float32, so in bf16 the two inner forms give the same
// bits and a source row that is the lower row of one output and the upper
// row of the other is interpolated once.
__device__ __forceinline__ float dot2_upper(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w1, x1, __fmul_rn(w0, x0));
}
__device__ __forceinline__ float dot2_lower(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w0, x0, __fmul_rn(w1, x1));
}
__device__ __forceinline__ float dot2_outer(float h0, float top, float h1, float bottom) {
  return __fmaf_rn(h0, top, __fmul_rn(h1, bottom));
}
template <typename T>
constexpr bool kExactProducts = sizeof(T) == 2;

// One output row's (or column's) source indices and weights, as ATen's
// area_pixel_compute_source_index and its caller form them.
struct Src {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Src source(int dst, int size) {
  float r = __fsub_rn(__fmul_rn(kScale, __fadd_rn((float)dst, 0.5f)), 0.5f);
  r = r < 0.f ? 0.f : r;
  Src s;
  s.i0 = (int)r;
  s.i1 = s.i0 + (s.i0 < size - 1 ? 1 : 0);
  s.l1 = __fsub_rn(r, (float)s.i0);
  s.l0 = __fsub_rn(1.f, s.l1);
  return s;
}

struct Shape {
  int c, h, w, H, W, hq, wq;
};

template <typename T, int V, bool kSum, typename I>
__global__ void __launch_bounds__(kThreads)
lfpn_fuse_kernel(const T *__restrict__ td, const T *__restrict__ lat, T *__restrict__ out,
                 Shape s, I items) {
  constexpr int kLanes = Word<T, V>::kLanes;
  const I item = (I)blockIdx.x * kThreads + threadIdx.x;
  if (item >= items) return;
  const int packs = s.c / V;
  const int g = (int)(item % packs);
  I rest = item / packs;
  const int qj = (int)(rest % s.wq);
  rest /= s.wq;
  const int qi = (int)(rest % s.hq);
  const long long n = (long long)(rest / s.hq);
  const Src ra = source(2 * qi, s.h), rb = source(2 * qi + 1, s.h);
  const Src ca = source(2 * qj, s.w), cb = source(2 * qj + 1, s.w);
  // Row a1 of the quad's top row: b0 where i > 0, b1 where i = 0; column
  // c1 of its left column likewise.
  const bool a1_is_b0 = ra.i1 == rb.i0, c1_is_d0 = ca.i1 == cb.i0;
  const T *src = td + n * s.h * s.w * s.c + g * V;
  const int rows[3] = {ra.i0, rb.i0, rb.i1};
  const int cols[3] = {ca.i0, cb.i0, cb.i1};
  Pack<T, V> p[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p[i][j].load_ro(src + ((long long)rows[i] * s.w + cols[j]) * s.c);
  const int y = 2 * qi, x = 2 * qj;
  const bool in[2][2] = {{true, x + 1 < s.W}, {y + 1 < s.H, y + 1 < s.H && x + 1 < s.W}};
  const long long o00 = ((n * s.H + y) * s.W + x) * s.c + g * V;
  // Every lateral load is issued, a pixel outside (H, W) reading o00's in
  // its place: a load under a branch is scheduled after the top-down
  // arithmetic, which cost 7 % on an H100.
  Pack<T, V> l[2][2], o[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      l[r][q].load(lat + (in[r][q] ? o00 + ((long long)r * s.W + q) * s.c : o00));
#pragma unroll
  for (int k = 0; k < Pack<T, V>::kWords; ++k) {
    float xs[3][3][kLanes], ls[2][2][kLanes], up[2][2][kLanes];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) to_floats(p[i][j].w[k], xs[i][j]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) to_floats(l[r][q].w[k], ls[r][q]);
#pragma unroll
    for (int e = 0; e < kLanes; ++e) {
      // Source rows a0 and b0 as the upper row of an output, b0 and b1 as
      // the lower one, each along the left output column (c0, c1) and the
      // right one (d0, d1).
      float up_l[2], up_r[2], lo_l[2], lo_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        up_l[i] = dot2_upper(ca.l0, xs[i][0][e], ca.l1, c1_is_d0 ? xs[i][1][e] : xs[i][2][e]);
        up_r[i] = dot2_upper(cb.l0, xs[i][1][e], cb.l1, xs[i][2][e]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kExactProducts<T> && i == 0) {
          lo_l[0] = up_l[1];
          lo_r[0] = up_r[1];
          continue;
        }
        const float(&xr)[3][kLanes] = xs[i + 1];
        lo_l[i] = dot2_lower(ca.l0, xr[0][e], ca.l1, c1_is_d0 ? xr[1][e] : xr[2][e]);
        lo_r[i] = dot2_lower(cb.l0, xr[1][e], cb.l1, xr[2][e]);
      }
      up[0][0][e] = dot2_outer(ra.l0, up_l[0], ra.l1, a1_is_b0 ? lo_l[0] : lo_l[1]);
      up[0][1][e] = dot2_outer(ra.l0, up_r[0], ra.l1, a1_is_b0 ? lo_r[0] : lo_r[1]);
      up[1][0][e] = dot2_outer(rb.l0, up_l[1], rb.l1, lo_l[1]);
      up[1][1][e] = dot2_outer(rb.l0, up_r[1], rb.l1, lo_r[1]);
    }
    // The upsampled values rounded to T (ATen writes them between its two
    // passes), then the product or the sum with the lateral values.
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        round_as<typename Word<T, V>::type>(up[r][q]);
#pragma unroll
        for (int e = 0; e < kLanes; ++e)
          up[r][q][e] = kSum ? __fadd_rn(up[r][q][e], ls[r][q][e])
                             : __fmul_rn(up[r][q][e], ls[r][q][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) from_floats(up[r][q], o[r][q].w[k]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (in[r][q]) o[r][q].store(out + o00 + ((long long)r * s.W + q) * s.c);
}

template <typename T, int V, bool kSum, typename I>
int launch(const T *td, const T *lat, T *out, const Shape &s, I items, cudaStream_t stream) {
  const unsigned long long blocks = ((unsigned long long)items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidConfiguration;
  lfpn_fuse_kernel<T, V, kSum, I><<<(unsigned)blocks, kThreads, 0, stream>>>(td, lat, out, s,
                                                                            items);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kSum>
int dispatch_index(const T *td, const T *lat, T *out, const Shape &s, long long batch,
                   cudaStream_t stream) {
  const long long items = batch * s.hq * s.wq * (s.c / V);
  if (items < (1LL << 32) - kThreads)
    return launch<T, V, kSum, unsigned>(td, lat, out, s, (unsigned)items, stream);
  return launch<T, V, kSum, unsigned long long>(td, lat, out, s, (unsigned long long)items,
                                                stream);
}

template <typename T, bool kSum>
int dispatch(const void *tdv, const void *latv, void *outv, const Shape &s, long long batch,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T *td = static_cast<const T *>(tdv);
  const T *lat = static_cast<const T *>(latv);
  T *out = static_cast<T *>(outv);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(td) | reinterpret_cast<uintptr_t>(lat) |
                         reinterpret_cast<uintptr_t>(out);
  if (s.c % V == 0 && addr % 16 == 0)
    return dispatch_index<T, V, kSum>(td, lat, out, s, batch, stream);
  return dispatch_index<T, 1, kSum>(td, lat, out, s, batch, stream);
}

}  // namespace

extern "C" {

// td (batch, h, w, c) and lat, out (batch, H, W, c), contiguous, out not
// overlapping either input; H <= 2h, W <= 2w; elem_bytes 2 (bf16) or 4
// (float32); sum 0 (product) or 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int lfpn_fuse_launch(const void *td, const void *lat, void *out, int batch, int c, int h, int w,
                     int H, int W, int elem_bytes, int sum, cudaStream_t stream) {
  if (batch < 0 || c <= 0 || h <= 0 || w <= 0 || H < 0 || W < 0 || H > 2 * h || W > 2 * w)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0 || W == 0) return 0;
  const Shape s{c, h, w, H, W, (H + 1) / 2, (W + 1) / 2};
  if (elem_bytes == 2)
    return sum ? dispatch<__nv_bfloat16, true>(td, lat, out, s, batch, stream)
               : dispatch<__nv_bfloat16, false>(td, lat, out, s, batch, stream);
  if (elem_bytes == 4)
    return sum ? dispatch<float, true>(td, lat, out, s, batch, stream)
               : dispatch<float, false>(td, lat, out, s, batch, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
