// Batched bbox-vote for Hopper (sm_90a): one thread block per image.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K7  dan_tpu/ops/bbox_vote_pallas.py::_vote_kernel_batched  (B images in lockstep)
//   K8  dan_tpu/ops/bbox_vote_pallas.py::_vote_kernel          (one image; here B = 1)
// and computes what they and dan_tpu/ops/bbox_vote.py compute.  Per image:
// a detection is active when it is valid and its score is > 0 (a NaN score
// is not); up to max_out times, take the active detection of highest score
// (lowest index on ties), merge every active detection whose IoU with it is
// >= the threshold (the selected one always merges), write the
// score-weighted mean of the merged boxes and the selected score into the
// next output slot, and deactivate what was merged.  Stop when nothing is
// active; the slots that were not reached are zero with valid = 0.
//
// What bounds it: not bytes.  One image reads 21 R bytes once (126 KB at
// R = 6000) and writes 21 max_out.  The cost is the greedy selection's
// serial depth: an output can be formed only once every better detection
// is decided.  The TPU kernel ran all images in lockstep as (B, R) vector
// ops, one dependent step an output (750).  The selection is greedy NMS
// with >= in place of >, and a detection is merged by the FIRST selected
// detection, in score order, whose IoU with it reaches the threshold.  So
// the vote is NMS's tile scan (nms.cu) that also records each merged
// detection's owner, followed by per-output sums:
//   1. load the row into shared memory and append the active detections'
//      sort keys ((bit-inverted score bits) << 32 | index: ascending keys
//      are descending scores, lowest index on ties; the bits of a positive
//      float keep its order); sort them with a bitonic network;
//   2. tile scan over the sorted list: the next 64 still-active detections
//      form a tile; a warp ballot packs each word of the 64 x 64 diagonal
//      merge bits; a serial walk of the words (redundant in every thread)
//      keeps detections up to max_out and gives every tile member merged by
//      a kept one that one's output slot; one sweep tests every later
//      active detection against the tile's kept ones in order, gives it the
//      slot of the first that merges it, and compacts the rest (a ballot
//      and a scan of the warps' counts), so tiles and warps stay dense;
//   3. the members of each slot, keyed (slot << 32 | index), sorted again,
//      and one warp a slot sums score, score * x1, ... in that fixed order
//      (lanes strided over the slot's members, then a shuffle tree): no
//      float atomics, the same bits from run to run;
//   4. box = sum(w * x) / max(sum(w), 1e-12), the selected score, valid.
// Shared memory: 32 bytes a detection (box 16, sort key 8, score 4, owner
// 4): 192 KB at R = 6000.  The sorted key array becomes the list of active
// indices, and then the members' key array; the owner array ends as the
// slots' first positions in it.
//
// Agreement with the plain version (dan_tpu_torch/ops/bbox_vote.py): every
// merge decision takes its IoU in the operation order of
// box/iou.py::iou_one_to_many with the selected box first (box_iou.cuh:
// IEEE division where the decision is near the threshold, the union > 0
// guard, NaN-propagating max / min), and the source is built with
// -fmad=false, so selection, scores, valid flags and output counts are
// bit-identical.  The weighted sums are float additions in another order
// than torch.sum; the fused boxes agree to rounding and never feed back into
// selection.  The plain version multiplies EVERY box of the row by its
// weight (0 when not merged), so a non-finite coordinate anywhere in the row
// makes that coordinate NaN in every output that does not merge it; the
// kernel counts non-finite coordinates per column and reproduces that.
#include <cuda_runtime.h>
#include <math.h>

#include "box_iou.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // detections a dependent step of the tile scan resolves
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBytesPerDet = 32;       // shared memory a detection takes
constexpr int kMaxShared = 227 * 1024;  // what a block may have on sm_90
constexpr int kStaticReserve = 4096;    // the static arrays below, with room

typedef unsigned long long u64;

__device__ __forceinline__ int lanes_below() {
  return (int)((1u << (threadIdx.x & 31)) - 1u);
}

// Append the keys of the threads where `take` holds to key[*n ...], in an
// order that does not matter (a sort follows).  Every thread of the block
// calls it.
__device__ __forceinline__ void append_key(bool take, u64 k, u64 *key, int *n) {
  const unsigned bal = __ballot_sync(kFull, take);
  int pos = 0;
  if ((threadIdx.x & 31) == 0 && bal) pos = atomicAdd(n, __popc(bal));
  pos = __shfl_sync(kFull, pos, 0);
  if (take) key[pos + __popc(bal & (unsigned)lanes_below())] = k;
}

// Ascending sort of key[0, n) in shared memory (the keys are distinct): the
// bitonic network of the next power of two in its form where every
// compare-exchange puts the smaller key at the lower position (the first
// step of each merge compares mirrored positions).  Positions >= n act as
// +infinity, which never moves, so they are neither read nor written.
__device__ __forceinline__ void sort_keys(u64 *key, int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  const int half = (1 << lg) >> 1;
  for (int lk = 1; lk <= lg; ++lk) {
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      for (int q = threadIdx.x; q < half; q += kThreads) {
        const int lo = ((q >> lj) << (lj + 1)) | (q & (j - 1));
        const int hi = lj == lk - 1 ? lo ^ ((1 << lk) - 1) : lo + j;
        if (hi < n) {
          const u64 a = key[lo], b = key[hi];
          if (b < a) {
            key[lo] = b;
            key[hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Whether the selected box (kb, karea) merges box (b, area): IoU >= thr.
__device__ __forceinline__ bool merges(float4 kb, float karea, float4 b, float area,
                                       float thr) {
  return iou_passes<true>(overlap_w(kb.x, kb.z, b.x, b.z), overlap_w(kb.y, kb.w, b.y, b.w),
                          karea, area, thr);
}

__device__ __forceinline__ float area_of(float4 b) { return box_area(b.x, b.y, b.z, b.w); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
bbox_vote_kernel(const float4 *__restrict__ boxes,         // (B, R)
                 const float *__restrict__ scores,         // (B, R)
                 const unsigned char *__restrict__ valid,  // (B, R) 0 / 1
                 float4 *__restrict__ out_boxes,           // (B, M)
                 float *__restrict__ out_scores,           // (B, M)
                 unsigned char *__restrict__ out_valid,    // (B, M)
                 int *__restrict__ tiles_out,              // (B,)
                 int r, int max_out, float iou_thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4 *sbox = reinterpret_cast<float4 *>(smem);
  u64 *skey = reinterpret_cast<u64 *>(smem + 16 * (size_t)r);
  float *sscore = reinterpret_cast<float *>(smem + 24 * (size_t)r);
  int *sowner = reinterpret_cast<int *>(smem + 28 * (size_t)r);
  __shared__ u64 sup[kTile];          // bit j of sup[i]: tile member i merges j > i
  __shared__ float4 kept_box[kTile];  // the tile's kept detections, packed
  __shared__ float kept_area[kTile];
  __shared__ int warp_total[2][kWarps];
  __shared__ int n_keys;
  __shared__ int bad[4];  // detections of the row with a non-finite x1, y1, x2, y2

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4 *b_in = boxes + (size_t)row * r;
  const float *s_in = scores + (size_t)row * r;
  const unsigned char *v_in = valid + (size_t)row * r;
  float4 *ob = out_boxes + (size_t)row * max_out;
  float *os = out_scores + (size_t)row * max_out;
  unsigned char *ov = out_valid + (size_t)row * max_out;

  if (tid < 4) bad[tid] = 0;
  if (tid == 0) n_keys = 0;
  __syncthreads();

  // 1. Load the row, append the active detections' keys, count the
  // non-finite coordinates.
  int nb0 = 0, nb1 = 0, nb2 = 0, nb3 = 0;
  for (int base = 0; base < r; base += kThreads) {
    const int k = base + tid;
    bool active = false;
    float sc = 0.0f;
    if (k < r) {
      const float4 b = __ldg(b_in + k);
      sc = __ldg(s_in + k);
      active = v_in[k] != 0 && sc > 0.0f;
      sbox[k] = b;
      sscore[k] = sc;
      sowner[k] = -1;
      nb0 += !isfinite(b.x);
      nb1 += !isfinite(b.y);
      nb2 += !isfinite(b.z);
      nb3 += !isfinite(b.w);
    }
    append_key(active, ((u64)(~__float_as_uint(sc)) << 32) | (unsigned)k, skey, &n_keys);
  }
  nb0 = warp_sum(nb0);
  nb1 = warp_sum(nb1);
  nb2 = warp_sum(nb2);
  nb3 = warp_sum(nb3);
  if (lane == 0 && (nb0 | nb1 | nb2 | nb3)) {
    atomicAdd(&bad[0], nb0);
    atomicAdd(&bad[1], nb1);
    atomicAdd(&bad[2], nb2);
    atomicAdd(&bad[3], nb3);
  }
  __syncthreads();
  const int n = n_keys;
  sort_keys(skey, n);

  // The sorted keys become the list of active indices, in place: chunk by
  // chunk, every thread reads its key before any writes an index (an index
  // lands on bytes of keys that this chunk or an earlier one has read).
  int *act = reinterpret_cast<int *>(skey);
  for (int base = 0; base < n; base += kThreads) {
    const int p = base + tid;
    const int idx = p < n ? (int)(unsigned)skey[p] : 0;
    __syncthreads();
    if (p < n) act[p] = idx;
  }
  __syncthreads();

  // 2. The tile scan; `count` and `m` are the same in every thread.
  int m = n;       // active detections left, at act[0, m)
  int count = 0;   // output slots taken
  int tiles = 0;
  while (m > 0 && count < max_out) {
    ++tiles;
    const int tn = min(kTile, m);
    // a. The tile's merge words: warp w makes rows w and w + 32, a lane the
    // bits lane and lane + 32.
#pragma unroll
    for (int h = 0; h < kTile / kWarps; ++h) {
      const int i = warp + h * kWarps;
      unsigned lo = 0, hi = 0;
      if (i < tn) {  // uniform in the warp
        const float4 bi = sbox[act[i]];
        const float ai = area_of(bi);
        bool t = false;
        if (lane > i && lane < tn) {
          const float4 bj = sbox[act[lane]];
          t = merges(bi, ai, bj, area_of(bj), iou_thr);
        }
        lo = __ballot_sync(kFull, t);
        t = false;
        if (32 + lane > i && 32 + lane < tn) {
          const float4 bj = sbox[act[32 + lane]];
          t = merges(bi, ai, bj, area_of(bj), iou_thr);
        }
        hi = __ballot_sync(kFull, t);
      }
      if (lane == 0) sup[i] = ((u64)hi << 32) | lo;
    }
    __syncthreads();

    // b. Walk the tile in order; every thread does the same walk on the same
    // words (a merged detection never selects).  Thread t < tn notes the
    // slot its tile member goes to: its own if kept, else the first kept
    // member's that merges it.
    u64 alive = tn == kTile ? ~0ull : (1ull << tn) - 1ull, kept = 0;
    const int base = count;
    int my_slot = -1;
    while (alive && count < max_out) {
      const int i = __ffsll((long long)alive) - 1;
      const u64 hit = sup[i] & alive;
      if (tid == i || (tid < kTile && ((hit >> tid) & 1ull))) my_slot = count;
      kept |= 1ull << i;
      alive &= ~(hit | (1ull << i));
      ++count;
    }

    // c. Owners of the tile's members; the kept ones' scores, and their
    // boxes packed for the sweep.
    if (tid < tn && my_slot >= 0) {
      const int b = act[tid];
      sowner[b] = my_slot;
      if ((kept >> tid) & 1ull) {
        const int c = my_slot - base;  // the kept members below tid
        const float4 bb = sbox[b];
        kept_box[c] = bb;
        kept_area[c] = area_of(bb);
        os[my_slot] = sscore[b];
        ov[my_slot] = 1;
      }
    }
    const int n_kept = __popcll(kept);
    __syncthreads();

    // d. One sweep over the rest of the list: a detection that a kept one
    // of this tile merges takes the first such one's slot and drops out,
    // the others move up in order.  It runs after the max_out cut too: the
    // last outputs still merge what follows them.
    int out = 0;
    int par = 0;
    for (int e0 = tn; e0 < m; e0 += kThreads, par ^= 1) {
      const int e = e0 + tid;
      bool live = false;
      int b = 0;
      if (e < m) {
        b = act[e];
        const float4 bb = sbox[b];
        const float area = area_of(bb);
        live = true;
        for (int c = 0; c < n_kept; ++c) {
          if (merges(kept_box[c], kept_area[c], bb, area, iou_thr)) {
            sowner[b] = base + c;
            live = false;
            break;
          }
        }
      }
      const unsigned bal = __ballot_sync(kFull, live);
      if (lane == 0) warp_total[par][warp] = __popc(bal);
      __syncthreads();
      int scan = warp_total[par][lane];  // inclusive scan over the 32 warps
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, scan, off);
        if (lane >= off) scan += up;
      }
      const int before = __shfl_sync(kFull, scan, max(warp - 1, 0));
      const int total = __shfl_sync(kFull, scan, 31);
      // Lands below e: in entries this chunk or an earlier one has read.
      if (live) act[out + (warp ? before : 0) + __popc(bal & (unsigned)lanes_below())] = b;
      out += total;
    }
    __syncthreads();
    m = out;
  }
  if (tid == 0) tiles_out[row] = tiles;

  // 3. Every merged detection keyed (slot, index), sorted: each slot's
  // members are a run, in index order.
  if (tid == 0) n_keys = 0;
  __syncthreads();
  for (int base = 0; base < r; base += kThreads) {
    const int k = base + tid;
    const int s = k < r ? sowner[k] : -1;
    append_key(s >= 0, ((u64)(unsigned)s << 32) | (unsigned)k, skey, &n_keys);
  }
  __syncthreads();
  const int n_mem = n_keys;
  sort_keys(skey, n_mem);
  __syncthreads();
  int *start = sowner;  // start[s]: the first position of slot s's run
  for (int p = tid; p < n_mem; p += kThreads) {
    const int s = (int)(skey[p] >> 32);
    if (p == 0 || (int)(skey[p - 1] >> 32) != s) start[s] = p;
  }
  __syncthreads();

  // 4. One warp a slot: the sums in a fixed order, the box, and the slots
  // past the last output zeroed.
  for (int s = warp; s < count; s += kWarps) {
    const int lo = start[s], hi = s + 1 < count ? start[s + 1] : n_mem;
    float aw = 0.0f, ax1 = 0.0f, ay1 = 0.0f, ax2 = 0.0f, ay2 = 0.0f;
    int mb0 = 0, mb1 = 0, mb2 = 0, mb3 = 0;
    for (int p = lo + lane; p < hi; p += 32) {
      const int k = (int)(unsigned)skey[p];
      const float4 b = sbox[k];
      const float w = sscore[k];
      aw += w;
      ax1 += b.x * w;
      ay1 += b.y * w;
      ax2 += b.z * w;
      ay2 += b.w * w;
      mb0 += !isfinite(b.x);
      mb1 += !isfinite(b.y);
      mb2 += !isfinite(b.z);
      mb3 += !isfinite(b.w);
    }
    aw = warp_sum(aw);
    ax1 = warp_sum(ax1);
    ay1 = warp_sum(ay1);
    ax2 = warp_sum(ax2);
    ay2 = warp_sum(ay2);
    mb0 = warp_sum(mb0);
    mb1 = warp_sum(mb1);
    mb2 = warp_sum(mb2);
    mb3 = warp_sum(mb3);
    if (lane == 0) {
      const float wsum = fmaxf(aw, 1e-12f);
      // A non-finite coordinate that this output does not merge reaches it
      // as x * 0 = NaN in the plain version's sum over the row.
      ob[s] = make_float4(bad[0] > mb0 ? NAN : ax1 / wsum, bad[1] > mb1 ? NAN : ay1 / wsum,
                          bad[2] > mb2 ? NAN : ax2 / wsum, bad[3] > mb3 ? NAN : ay2 / wsum);
    }
  }
  for (int s = count + tid; s < max_out; s += kThreads) {
    ob[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    os[s] = 0.0f;
    ov[s] = 0;
  }
}

bool g_configured = false;  // the opt-in shared memory is set once a process

}  // namespace

extern "C" {

// Largest row length the kernel takes: 32 bytes a detection in shared
// memory, within the 227 KB a block may use on sm_90.
int bbox_vote_max_rows() { return (kMaxShared - kStaticReserve) / kBytesPerDet; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// boxes must be 16-byte aligned.  tiles (B,) receives each row's dependent
// steps.
int bbox_vote_launch(const float *boxes, const float *scores, const unsigned char *valid,
                     float *out_boxes, float *out_scores, unsigned char *out_valid, int *tiles,
                     int batch, int r, int max_out, float iou_thr, void *stream) {
  if (r < 1 || r > bbox_vote_max_rows() || max_out < 1) return (int)cudaErrorInvalidValue;
  if (!g_configured) {
    cudaError_t err = cudaFuncSetAttribute(bbox_vote_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxShared - kStaticReserve);
    if (err != cudaSuccess) return (int)err;
    g_configured = true;
  }
  const size_t smem = (size_t)kBytesPerDet * r;
  bbox_vote_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4 *>(boxes), scores, valid,
      reinterpret_cast<float4 *>(out_boxes), out_scores, out_valid, tiles, r, max_out,
      iou_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
