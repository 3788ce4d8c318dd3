// The gradient of the LFPN's 2x bilinear upsample (half-pixel centres, edge
// clamped) for Hopper (sm_90a): the transpose of the upsample, as a gather.
//
//   g  (P, 2H, 2W) bf16 or float32, the gradient of the upsampled map
//      (P = N * C planes of a contiguous NCHW tensor)
//   gx (P, H, W) in g's dtype:
//     along H:  t[i]  = ((0.25 e0 + 0.75 o0) + 0.75 e1) + 0.25 o1
//               with e0 = g[2i - 1], o0 = g[2i], e1 = g[2i + 1], o1 = g[2i + 2]
//               and the row indices clamped to [0, 2H - 1];
//     along W:  the same over t's columns 2j - 1 .. 2j + 2;
//     then one round to nearest even into the dtype.
//
// It replaces no Pallas kernel: in the JAX package the upsample is
// jax.image.resize (dan_tpu/models/layers.py:94-105), whose transpose XLA
// lowers to dense dots, which are deterministic.  ATen's CUDA backward of
// upsample_bilinear2d scatters with atomic adds, so two train steps from one
// state differed in their last bits; this kernel gathers, each output from
// its own clamped patch of g, so every sum has one order.  Every product and
// every sum is one float32 operation rounded to nearest (__fmul_rn,
// __fadd_rn; built with -fmad=false), in the order of the plain version
// (ops/upsample_cuda.py::upsample2x_bwd_plain), so the two agree bit for bit.
//
// What bounds it: bytes.  Each g element is read once and each gx element
// written once (5 bytes of traffic for 4 g bytes; 21 float32 operations an
// output, far under the card's rate for those bytes).  So the design keeps
// loads in flight all the time:
//
//   * Persistent blocks, as many as fit the SMs (three a SM at the default
//     stage size), each walking the items blockIdx.x, + gridDim.x, ...
//   * An item is one contiguous span of g: several whole planes where a
//     plane is small (the 40x40 g of the first LFPN call: 5 planes, 16 KB),
//     else a band of output rows of one plane with its two halo rows (a
//     band's g rows 2 i0 - 1 .. 2 (i0 + R), clamped).  The wrapper's plan
//     (ops/upsample_cuda.py::plan) sizes items to a stage, 16 KB by default.
//   * A ring of 4 stages in shared memory.  Warp 0's first thread fills it
//     with 1-D TMA bulk copies (cp.async.bulk), one `full` mbarrier a stage
//     counting the bytes; the eight consumer warps compute stage s while the
//     next three load, and each releases s on its `empty` mbarrier.  A span
//     off a 16-byte boundary is copied as its aligned interior by TMA and a
//     head and a tail of at most 15 bytes by plain loads.
//   * No float32 band in shared memory: a consumer thread takes G = 16 bytes
//     of each of the four g rows its output row reads (G = 4 bf16 or 2
//     float32 outputs: one 16-byte load a row), makes the 2G H-pass values t
//     in registers, takes t at the group's two edge columns from its
//     neighbouring lanes (__shfl; a lane at a warp's edge recomputes that
//     column from its four g values, which gives the same bits), and writes
//     its G outputs with one 8-byte store.  A g that is not 16-byte aligned,
//     or a W that is no multiple of G, takes G = 1: one output a thread from
//     its 4x4 patch with element loads.  The bits are the same either way:
//     each output is the same float32 operations on the same inputs in the
//     same order.
//
// What is left after the bytes is the first fill of each block's ring and
// the tail where some blocks take one item more than others.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = 32 + kConsumers;  // warp 0 is the producer
constexpr int kStages = 4;
constexpr int kAlign = 128;
constexpr int kMaxSmem = 232448;  // a block's opt-in maximum on sm_90 (227 KB)

struct Params {
  const void *g;
  void *gx;
  long long planes, items;
  int h, w;
  int per_item;     // whole planes an item (1 when a plane is cut into bands)
  int band, bands;  // output rows an item of one plane, bands a plane
  int stride;       // bytes between ring stages
};

// Bytes between stages holding spans of up to stage_bytes, shifted by up to
// 15 bytes to the span's alignment.
__host__ __device__ constexpr int stage_stride(int stage_bytes) {
  return (stage_bytes + 16 + kAlign - 1) / kAlign * kAlign;
}
constexpr size_t smem_bytes(int stage_bytes) {
  return (size_t)kStages * stage_stride(stage_bytes) + kAlign;
}
// The largest stage that fits the ring in a block's shared memory.
constexpr int kMaxStageBytes = ((kMaxSmem - kAlign) / kStages / kAlign * kAlign - 16) / 16 * 16;

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spin until the barrier's phase differs from `parity`.  A wait here lasts
// microseconds; one that outlasts 10 s of the global timer is a lost arrival,
// and a trap (the launch then fails) is better than a block that never ends.
// (A poll count is no bound: try_wait may suspend the thread on each poll.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  uint64_t start = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++polls & 255) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) {
        start = now;
      } else if (now - start > 10000000000ull) {
        __trap();
      }
    }
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void *src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of one g row as float32: 4 float32 or 8 bf16 (element 2m in the
// low half of word m).
__device__ __forceinline__ void load16(const float *p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4 *>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16 *p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4 *>(p);
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[2 * m] = __uint_as_float(words[m] << 16);
    v[2 * m + 1] = __uint_as_float(words[m] & 0xffff0000u);
  }
}

// G outputs, each rounded to nearest even into the dtype, in one 8-byte store.
__device__ __forceinline__ void store_group(float *p, const float (&o)[2]) {
  *reinterpret_cast<float2 *>(p) = make_float2(o[0], o[1]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16 *p, const float (&o)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2 *>(p) =
      make_uint2(*reinterpret_cast<const uint32_t *>(&a), *reinterpret_cast<const uint32_t *>(&b));
}
__device__ __forceinline__ void store1(float *p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16 *p, float v) { *p = __float2bfloat16_rn(v); }

// ((0.25 a + 0.75 b) + 0.75 c) + 0.25 d, each step rounded as PyTorch's
// float32 tensor ops round it.
__device__ __forceinline__ float adjoint4(float a, float b, float c, float d) {
  float s = __fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.75f, b));
  s = __fadd_rn(s, __fmul_rn(0.75f, c));
  return __fadd_rn(s, __fmul_rn(0.25f, d));
}

// One item: planes p0 .. p0 + np - 1, output rows i0 .. i0 + rows - 1 of
// each (np > 1 only with whole planes); its g span starts at element
// `begin` (row lo of plane p0) and holds `count` elements.
struct Item {
  long long p0;
  int np, i0, rows, lo;
  size_t begin, count;
};

__device__ __forceinline__ Item item_at(const Params &p, long long it) {
  Item t;
  if (p.bands == 1) {
    t.p0 = it * p.per_item;
    t.np = (int)min((long long)p.per_item, p.planes - t.p0);
    t.i0 = 0;
    t.rows = p.h;
  } else {
    t.p0 = it / p.bands;
    t.i0 = (int)(it - t.p0 * p.bands) * p.band;
    t.rows = min(p.band, p.h - t.i0);
    t.np = 1;
  }
  t.lo = max(2 * t.i0 - 1, 0);
  const int hi = min(2 * (t.i0 + t.rows), 2 * p.h - 1);
  const size_t w2 = 2 * (size_t)p.w;
  t.begin = ((size_t)t.p0 * 2 * p.h + t.lo) * w2;
  t.count = ((size_t)(t.np - 1) * 2 * p.h + (hi - t.lo + 1)) * w2;
  return t;
}

// Walks the (row, group) pairs r * width + c of an item from a consumer's
// index in steps of kConsumers without a division a step.
struct Walk {
  int r, c, dr, dc, width;
  __device__ Walk(int first, int w) : width(w) {
    r = first / w;
    c = first - r * w;
    dr = kConsumers / w;
    dc = kConsumers - dr * w;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

// The four g rows that output row i reads, as offsets into the span (row R
// of the item's plane lp begins at (lp * 2H + R - lo) * 2W).
struct Rows {
  size_t off[4];
  __device__ Rows(const Params &p, const Item &t, int lp, int i) {
    const size_t w2 = 2 * (size_t)p.w;
    const long long base = (long long)lp * 2 * p.h - t.lo;
    off[0] = (size_t)(base + max(2 * i - 1, 0)) * w2;
    off[1] = (size_t)(base + 2 * i) * w2;
    off[2] = (size_t)(base + 2 * i + 1) * w2;
    off[3] = (size_t)(base + min(2 * i + 2, 2 * p.h - 1)) * w2;
  }
};

// The H-pass value t at column k of an output row from its four g values.
template <typename T>
__device__ __forceinline__ float t_at(const T *gs, const Rows &rw, int k) {
  return adjoint4(to_float(gs[rw.off[0] + k]), to_float(gs[rw.off[1] + k]),
                  to_float(gs[rw.off[2] + k]), to_float(gs[rw.off[3] + k]));
}

// An item's outputs, G a consumer thread: gs[e] is g[t.begin + e].
template <typename T, int G>
__device__ __forceinline__ void compute_item(const Params &p, const Item &t, const T *gs,
                                             const Walk &start, int lane) {
  T *gx = static_cast<T *>(p.gx);
  const int total = t.np * t.rows;  // output rows of the item
  Walk at = start;
  int lp = 0, rl = at.r;  // at.r as (plane of the item, row of the item's band)
  while (rl >= t.rows) rl -= t.rows, ++lp;
  for (;;) {
    const bool active = at.r < total;
    if constexpr (G == 1) {
      if (!active) break;
    } else if (!__any_sync(0xffffffffu, active)) {
      break;
    }
    const int i = t.i0 + rl;
    const int j = at.c * G;
    T *dst = gx + ((size_t)(t.p0 + lp) * p.h + i) * p.w + j;
    const Rows rw(p, t, lp, i);  // offsets only: nothing is loaded for an idle lane
    if constexpr (G == 1) {
      const int w2 = 2 * p.w;
      store1(dst, adjoint4(t_at(gs, rw, max(2 * j - 1, 0)), t_at(gs, rw, 2 * j),
                           t_at(gs, rw, 2 * j + 1), t_at(gs, rw, min(2 * j + 2, w2 - 1))));
    } else {
      // t at columns 2j .. 2j + 2G - 1 (16 bytes of each of the four rows).
      float tv[2 * G];
      if (active) {
        float v[4][2 * G];
#pragma unroll
        for (int q = 0; q < 4; ++q) load16(gs + rw.off[q] + 2 * j, v[q]);
#pragma unroll
        for (int k = 0; k < 2 * G; ++k) tv[k] = adjoint4(v[0][k], v[1][k], v[2][k], v[3][k]);
      } else {
#pragma unroll
        for (int k = 0; k < 2 * G; ++k) tv[k] = 0.f;
      }
      // t at 2j - 1 and 2j + 2G: the neighbouring lanes' last and first
      // columns where they hold the neighbouring groups of the same row;
      // the clamped edge at a row's ends; recomputed at a warp's edges.
      float left = __shfl_up_sync(0xffffffffu, tv[2 * G - 1], 1);
      float right = __shfl_down_sync(0xffffffffu, tv[0], 1);
      if (active) {
        if (at.c == 0) {
          left = tv[0];
        } else if (lane == 0) {
          left = t_at(gs, rw, 2 * j - 1);
        }
        if (at.c == at.width - 1) {
          right = tv[2 * G - 1];
        } else if (lane == 31) {
          right = t_at(gs, rw, 2 * j + 2 * G);
        }
        float o[G];
#pragma unroll
        for (int m = 0; m < G; ++m) {
          const float a = m == 0 ? left : tv[2 * m - 1];
          const float d = m == G - 1 ? right : tv[2 * m + 2];
          o[m] = adjoint4(a, tv[2 * m], tv[2 * m + 1], d);
        }
        store_group(dst, o);
      }
    }
    const int r0 = at.r;
    at.next();
    rl += at.r - r0;
    while (rl >= t.rows) rl -= t.rows, ++lp;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 2) upsample2x_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  unsigned char *ring = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uintptr_t g_addr = reinterpret_cast<uintptr_t>(p.g);
  if (warp == 0) {
    // ---- producer: one thread keeps the ring full ------------------------
    if (lane != 0) return;
    uint32_t n = 0;
    for (long long it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
      const int s = n % kStages;
      mbar_wait(smem_u32(&empty_bar[s]), ((n / kStages) & 1) ^ 1);
      const Item t = item_at(p, it);
      const unsigned char *src =
          reinterpret_cast<const unsigned char *>(g_addr + t.begin * sizeof(T));
      const uint32_t bytes = (uint32_t)(t.count * sizeof(T));
      unsigned char *dst = ring + (size_t)s * p.stride + ((uintptr_t)src & 15);
      const uint32_t head = min((uint32_t)((16 - ((uintptr_t)src & 15)) & 15), bytes);
      const uint32_t body = (bytes - head) & ~15u;
      const uint32_t tail = bytes - head - body;
      if (head | tail) {
        for (uint32_t k = 0; k < head; ++k) dst[k] = src[k];
        for (uint32_t k = head + body; k < bytes; ++k) dst[k] = src[k];
        // These bytes are written by this thread, a later round's bytes of
        // the stage by the copy engine: order the two.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      const uint32_t full = smem_u32(&full_bar[s]);
      mbar_expect_tx(full, body);  // this thread's arrival, releasing the head and tail
      if (body) bulk_copy(smem_u32(dst + head), src + head, body, full);
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  const Walk start(threadIdx.x - 32, p.w / G);
  uint32_t n = 0;
  for (long long it = blockIdx.x; it < p.items; it += gridDim.x, ++n) {
    const int s = n % kStages;
    mbar_wait(smem_u32(&full_bar[s]), (n / kStages) & 1);
    const Item t = item_at(p, it);
    const T *gs = reinterpret_cast<const T *>(ring + (size_t)s * p.stride +
                                              ((g_addr + t.begin * sizeof(T)) & 15));
    compute_item<T, G>(p, t, gs, start, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
  }
}

template <typename T, int G>
const void *kernel_fn() {
  return reinterpret_cast<const void *>(upsample2x_bwd_kernel<T, G>);
}

const void *kernel_for(int elem_bytes, int group) {
  if (elem_bytes == 2) return group == 1 ? kernel_fn<__nv_bfloat16, 1>() : kernel_fn<__nv_bfloat16, 4>();
  return group == 1 ? kernel_fn<float, 1>() : kernel_fn<float, 2>();
}

// Sets the kernel's shared-memory attribute for this launch (it is per
// device) and returns the blocks of the persistent grid: as many as fit the
// SMs at this stage size, at most one an item.  The count is kept for each
// (device, kernel, stage size), so the runtime is asked once.  Returns a
// CUDA error as a negative number.
long long grid_of(const void *fn, long long items, int stage_bytes) {
  struct Entry {
    int dev;
    const void *fn;
    int stage_bytes, blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  const size_t smem = smem_bytes(stage_bytes);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(long long)err;
  int blocks = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry &e : known)
      if (e.dev == dev && e.fn == fn && e.stage_bytes == stage_bytes) blocks = e.blocks;
  }
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (err != cudaSuccess) return -(long long)err;
    if (per_sm < 1) return -(long long)cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    std::lock_guard<std::mutex> lock(mu);
    known.push_back({dev, fn, stage_bytes, blocks});
  }
  return items < blocks ? items : blocks;
}

bool valid(long long planes, int h, int w, int elem_bytes, int per_item, int band,
           int stage_bytes, int group) {
  if (planes <= 0 || h <= 0 || w <= 0 || (elem_bytes != 2 && elem_bytes != 4)) return false;
  if (stage_bytes <= 0 || stage_bytes % 16 || stage_bytes > kMaxStageBytes) return false;
  if (group != 1 && (group != 8 / elem_bytes || w % group)) return false;
  if (per_item < 1 || band < 1 || band > h || (per_item > 1 && band != h)) return false;
  const long long row = 2LL * w * elem_bytes;  // bytes of a g row
  const long long span = band == h ? per_item * 2LL * h * row : (2LL * band + 2) * row;
  return span <= stage_bytes;
}

}  // namespace

extern "C" {

// Widest output row the kernel takes: an item of one output row (four g
// rows) must fit the largest stage.
int upsample2x_bwd_max_w(int elem_bytes) { return kMaxStageBytes / (8 * elem_bytes); }

// Blocks the launch takes for `items` items (a negative CUDA error on failure).
long long upsample2x_bwd_grid(long long items, int elem_bytes, int stage_bytes, int group) {
  return grid_of(kernel_for(elem_bytes, group), items, stage_bytes);
}

// g (planes, 2h, 2w) and gx (planes, h, w), contiguous, elem_bytes 2 (bf16)
// or 4 (float32), cut as ops/upsample_cuda.py::plan cuts it: items of
// per_item whole planes (band == h) or of `band` output rows of one plane,
// each span at most stage_bytes; group 1, or 8 / elem_bytes outputs a thread
// (then g 16-byte and gx 8-byte aligned and w a multiple of it).  Launches on
// `stream` and returns a CUDA error code (0 on success).
int upsample2x_bwd_launch(const void *g, void *gx, long long planes, int h, int w,
                          int elem_bytes, int per_item, int band, int stage_bytes, int group,
                          cudaStream_t stream) {
  if (!valid(planes, h, w, elem_bytes, per_item, band, stage_bytes, group))
    return (int)cudaErrorInvalidValue;
  if (group != 1 && (reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(gx) % 8))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.g = g;
  p.gx = gx;
  p.planes = planes;
  p.h = h;
  p.w = w;
  p.per_item = per_item;
  p.band = band;
  p.bands = (h + band - 1) / band;
  p.items = (planes + per_item - 1) / per_item * p.bands;
  p.stride = stage_stride(stage_bytes);
  const void *fn = kernel_for(elem_bytes, group);
  const long long grid = grid_of(fn, p.items, stage_bytes);
  if (grid < 0) return (int)-grid;
  void *args[] = {&p};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(kThreads), args,
                                     smem_bytes(stage_bytes), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
