// Pairwise rotated-BEV IoU of convex quads, for Hopper (sm_90a).
//
// Replaces the TPU kernel coalign_tpu/ops/pallas_iou.py:_iou_kernel (called
// through rotated_iou_pallas). It computes the same function: for every pair
// (i, j) of boxes given by their 4 BEV corners,
//   1. candidate vertices: the corners of each quad that lie inside the other
//      (edge cross products, eps 1e-6, either winding) and the 16 edge-edge
//      crossings (eps 1e-9);
//   2. their centroid, and a pseudo-angle key of each candidate around it
//      (a monotone, transcendental-free stand-in for atan2);
//   3. the candidates sorted by key;
//   4. the shoelace area of the sorted ring, 0 with fewer than 3 candidates;
//   5. IoU = inter / (a1 + a2 - inter), 0 when the union is <= 1e-9.
//
// What bounds it on this card: scalar f32 work, and only for the pairs that
// overlap. On the detector's inputs (one frame's boxes against themselves)
// almost every pair is far apart, and such a pair needs a centre-distance
// test of ~8 operations: at 512 x 512 the function needs ~7 million
// operations, 0.1 us of the card's f32 rate, less than writing its 1 MiB
// output takes (0.3 us at 3.35 TB/s), and less than the ~1 us that any
// launch writing that output takes on this card (chip_smoke.py reports it
// as write_floor_ms). The rest of the kernel's time is the latency of the
// survivors' candidate path, a few thousand dependent instructions a pair;
// where boxes are packed densely, its throughput. No tensor-core form
// exists for it.
//
// What the design does about that:
//   1. Per-box values once per block, in shared memory. A block of 256
//      threads takes a tile of 32 rows and 32 columns and stages its 32 row
//      and 32 column boxes once: corners, edge vectors, area, centre and
//      reach (circumradius plus half the separation margin; infinite for a
//      degenerate box). A record is 21 floats, an odd stride, so lanes
//      reading consecutive column boxes hit distinct banks. A tile's rows
//      are strided over the matrix (row blockIdx.y + r * gridDim.y): boxes
//      adjacent in the caller's order, such as the NMS's score-sorted
//      anchors of one object, then spread their overlapping pairs over many
//      blocks instead of piling them into one, whose survivors would
//      otherwise run in several rounds while the rest of the card waits.
//   2. An exact separation cull. A pair whose centres lie farther apart
//      than the sum of their reaches is cleared: it gets exactly 0.0f and
//      does no more work. Why this is exact: a box is degenerate (reach
//      infinite, never cleared) unless every edge is >= 0.1 m and every
//      corner is within ~0.6 degrees of square. Two such boxes whose
//      circumcircles are more than 1e-2 m apart put each corner of one at
//      least ~7e-3 m beyond an edge line of the other, a cross product of
//      >= 7e-4, far beyond the point-in-quad eps (1e-6) and the float32
//      rounding at +-200 m (~1e-4); the reversed winding fails because the
//      4 cross products sum to twice the quad's area (>= 0.02); the segments
//      are >= 1e-2 m apart, so no crossing lies on both. The reference then
//      finds fewer than 3 candidates and gives 0. The same predicate is
//      coalign_tpu_torch/utils/iou.py separated_pairs, which the CPU tests
//      hold against the JAX package (tests/test_torch_iou_cull.py).
//   3. Block-local compaction. Warp w culls rows w, w+8, w+16, w+24 with
//      its 32 lanes on 32 consecutive columns, so every zero store of a
//      cleared pair is part of one 128-byte line. The surviving pairs are
//      appended to a list in shared memory (one ballot per row, one shared
//      atomicAdd per warp); after a barrier the block's threads take the
//      list in strides, so a warp runs 32 survivors together instead of a
//      few survivors among idle lanes. No device scratch, no second launch.
//   4. Division-free crossing tests. A crossing is decided from its
//      numerators against the signed denominator (t * |d| in
//      [-1e-9 |d|, |d|], the same for u, and |d| >= 1e-9), and only a
//      crossing that passes is divided (the fast divide), for its point.
//      The edge vectors come from shared memory. The accepted set can differ
//      from the divided form only for a crossing within rounding of an
//      edge's end, which is then also a corner candidate, so the ring's area
//      does not change.
//   5. The survivors' candidates in registers. The 24 candidate slots keep
//      the reference's fixed order, invalid ones keyed +inf, and a
//      127-comparator sorting network orders them: every index is known at
//      compile time, so nothing goes to local memory and every lane runs the
//      same instructions. (Compacting them and insertion-sorting them keeps
//      them in a 288-byte local array at data-dependent indices, which
//      measured slower: PERF.md.) The kernel is held to 80 registers, 3
//      blocks an SM, so that more warps hide the path's latency.
//   A leading batch dimension is the grid's z axis, so one launch covers
//   every frame of a batch.
//
// Precision: every pair is computed in a frame whose origin is the row box's
// first corner, and each box's area relative to its own first corner. IoU
// does not change under translation, and the shoelace sums then cancel over
// metres instead of over world coordinates: at +-140 m (the flagship's
// range) the untranslated float32 form of the JAX package cancels down to
// about 5e-4 of IoU, the translated one stays within 1e-6 of float64
// (tests/test_torch_iou.py). The plain PyTorch version
// (coalign_tpu_torch/utils/iou.py) translates the same way.
//
// C interface (bound with ctypes, no PyTorch headers):
//   int rotated_iou_launch(const float* corners1,  // (batch, n, 4, 2)
//                          const float* corners2,  // (batch, m, 4, 2)
//                          float* out,             // (batch, n, m)
//                          int batch, int n, int m, void* stream);
// returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                      // 256 threads a block
constexpr int kRowsPerWarp = 4;                // warp w culls rows w + 8 s
constexpr int kRows = kWarps * kRowsPerWarp;   // a tile's rows
constexpr int kCols = 32;                      // a tile's columns, one a lane
// 3 blocks of 256 threads an SM hold the kernel to 80 registers (ptxas
// spills 24 bytes), and give the survivors' path 24 warps an SM instead of
// the 16 that its 108 registers would leave
constexpr int kBlocksPerSM = 3;
constexpr int kSlots = 24;  // candidate slots: 4 + 4 corners, 16 crossings

// the cull's constants; utils/iou.py separated_pairs uses the same
constexpr float kSepMargin = 1e-2f;  // metres between the circumcircles
constexpr float kMinEdge = 0.1f;     // metres
constexpr float kSquareCos = 1e-2f;  // |cos| of a corner, ~0.6 deg off 90

// a box's record in shared memory
constexpr int kX = 0;       // 4 corners' x, then their y
constexpr int kY = 4;
constexpr int kEX = 8;      // edge k = corner k+1 - corner k
constexpr int kEY = 12;
constexpr int kArea = 16;   // shoelace area, relative to corner 0
constexpr int kCX = 17;     // mean of the corners
constexpr int kCY = 18;
constexpr int kReach = 19;  // circumradius + kSepMargin / 2, inf if degenerate
constexpr int kStride = 21;  // 20 fields; odd: column reads are conflict-free

// Reads box ``src`` (4 x (x, y), or zeros when not ``live``) and writes its
// record to ``dst``.
__device__ __forceinline__ void stage_box(const float* __restrict__ src,
                                          bool live, float* dst) {
  float x[4], y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = live ? src[2 * k] : 0.f;
    y[k] = live ? src[2 * k + 1] : 0.f;
  }
  float ex[4], ey[4], len2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    ex[k] = x[k2] - x[k];
    ey[k] = y[k2] - y[k];
    len2[k] = ex[k] * ex[k] + ey[k] * ey[k];
  }
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    tot += (x[k] - x[0]) * (y[k2] - y[0]) - (x[k2] - x[0]) * (y[k] - y[0]);
  }
  const float cx = 0.25f * ((x[0] + x[1]) + (x[2] + x[3]));
  const float cy = 0.25f * ((y[0] + y[1]) + (y[2] + y[3]));
  float r2 = 0.f;
  // written so that NaN corners leave ``ok`` false
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    const float dx = x[k] - cx, dy = y[k] - cy;
    r2 = fmaxf(r2, dx * dx + dy * dy);
    const float dot = ex[k] * ex[k2] + ey[k] * ey[k2];
    ok = ok && len2[k] >= kMinEdge * kMinEdge &&
         dot * dot <= kSquareCos * kSquareCos * len2[k] * len2[k2];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dst[kX + k] = x[k];
    dst[kY + k] = y[k];
    dst[kEX + k] = ex[k];
    dst[kEY + k] = ey[k];
  }
  dst[kArea] = 0.5f * fabsf(tot);
  dst[kCX] = cx;
  dst[kCY] = cy;
  dst[kReach] = ok ? sqrtf(r2) + 0.5f * kSepMargin
                  : __int_as_float(0x7f800000);  // +inf
}

// Point (px, py) inside the convex quad (qx, qy) with edges (ex, ey), either
// winding.
__device__ __forceinline__ bool in_quad(float px, float py, const float* qx,
                                        const float* qy, const float* ex,
                                        const float* ey) {
  bool pos = true;
  bool neg = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cr = ex[k] * (py - qy[k]) - ey[k] * (px - qx[k]);
    pos = pos && (cr >= -1e-6f);
    neg = neg && (cr <= 1e-6f);
  }
  return pos || neg;
}

// The key only orders the candidates, so the fast divide (2 ulp) does.
__device__ __forceinline__ float pseudo_angle(float dx, float dy) {
  const float p = __fdividef(dy, fabsf(dx) + fabsf(dy) + 1e-12f);
  return dx >= 0.f ? p : 2.f - p;
}

// Batcher's odd-even merge sort of 24 keys, less 5 comparators that no
// input needs: 127 compare-exchanges in 15 layers (tests/test_torch_iou.py
// checks that it sorts every 0/1 input, hence every input).
#define SORT24(X)                                                            \
  X(0, 1) X(2, 3) X(4, 5) X(6, 7) X(8, 9) X(10, 11) X(12, 13) X(14, 15)      \
  X(16, 17) X(18, 19) X(20, 21) X(22, 23) X(0, 2) X(1, 3) X(4, 6) X(5, 7)    \
  X(8, 10) X(9, 11) X(12, 14) X(13, 15) X(16, 18) X(17, 19) X(20, 22)        \
  X(21, 23) X(1, 2) X(5, 6) X(9, 10) X(13, 14) X(17, 18) X(21, 22) X(0, 4)   \
  X(1, 5) X(2, 6) X(3, 7) X(8, 12) X(9, 13) X(10, 14) X(11, 15) X(16, 20)    \
  X(17, 21) X(18, 22) X(19, 23) X(2, 4) X(3, 5) X(10, 12) X(11, 13)          \
  X(18, 20) X(19, 21) X(1, 2) X(3, 4) X(5, 6) X(9, 10) X(11, 12) X(13, 14)   \
  X(17, 18) X(19, 20) X(21, 22) X(0, 8) X(1, 9) X(2, 10) X(3, 11) X(4, 12)   \
  X(5, 13) X(6, 14) X(7, 15) X(4, 8) X(5, 9) X(6, 10) X(7, 11) X(2, 4)       \
  X(3, 5) X(6, 8) X(7, 9) X(10, 12) X(11, 13) X(1, 2) X(3, 4) X(5, 6)        \
  X(7, 8) X(9, 10) X(11, 12) X(13, 14) X(0, 16) X(1, 17) X(2, 18) X(3, 19)   \
  X(4, 20) X(5, 21) X(6, 22) X(7, 23) X(8, 16) X(9, 17) X(10, 18) X(11, 19)  \
  X(12, 20) X(13, 21) X(14, 22) X(15, 23) X(4, 8) X(5, 9) X(6, 10) X(7, 11)  \
  X(12, 16) X(13, 17) X(14, 18) X(15, 19) X(2, 4) X(3, 5) X(6, 8) X(7, 9)    \
  X(10, 12) X(11, 13) X(14, 16) X(15, 17) X(18, 20) X(19, 21) X(1, 2)        \
  X(3, 4) X(5, 6) X(7, 8) X(9, 10) X(11, 12) X(13, 14) X(15, 16) X(17, 18)   \
  X(19, 20) X(21, 22)

// Orders slots a < b by key, co-moving the coordinates. Called with literal
// indices only, so the arrays stay in registers.
__device__ __forceinline__ void compare_exchange(float* key, float* x,
                                                 float* y, int a, int b) {
  const bool swap = key[b] < key[a];
  const float ka = key[a], kb = key[b];
  const float xa = x[a], xb = x[b];
  const float ya = y[a], yb = y[b];
  key[a] = swap ? kb : ka;
  key[b] = swap ? ka : kb;
  x[a] = swap ? xb : xa;
  x[b] = swap ? xa : xb;
  y[a] = swap ? yb : ya;
  y[b] = swap ? ya : yb;
}

// IoU of the row box ``R`` and the column box ``C`` (shared-memory records),
// in the frame whose origin is R's first corner. The 24 candidates keep the
// reference's slots (R's corners, C's corners, crossing 4 a + e of R's edge a
// and C's edge e), in registers; invalid slots sort last.
__device__ float pair_iou(const float* R, const float* C) {
  const float ox = R[kX];
  const float oy = R[kY];
  float q1x[4], q1y[4], q2x[4], q2y[4], e1x[4], e1y[4], e2x[4], e2y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q1x[k] = R[kX + k] - ox;
    q1y[k] = R[kY + k] - oy;
    q2x[k] = C[kX + k] - ox;
    q2y[k] = C[kY + k] - oy;
    e1x[k] = R[kEX + k];
    e1y[k] = R[kEY + k];
    e2x[k] = C[kEX + k];
    e2y[k] = C[kEY + k];
  }

  float px[kSlots], py[kSlots];
  unsigned valid = 0u;  // bit s: slot s is a candidate
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = q1x[k];
    py[k] = q1y[k];
    valid |= (unsigned)in_quad(q1x[k], q1y[k], q2x, q2y, e2x, e2y) << k;
    px[4 + k] = q2x[k];
    py[4 + k] = q2y[k];
    valid |= (unsigned)in_quad(q2x[k], q2y[k], q1x, q1y, e1x, e1y) << (4 + k);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 8 + 4 * a + e;
      const float d = e1x[a] * e2y[e] - e1y[a] * e2x[e];
      const float ad = fabsf(d);
      // t = tn / ad and u = un / ad, tested before dividing; 1 + 1e-9
      // rounds to 1 in float32, as in the divided form's test
      const float sg = d < 0.f ? -1.f : 1.f;
      const float qpx = q2x[e] - q1x[a];
      const float qpy = q2y[e] - q1y[a];
      const float tn = sg * (qpx * e2y[e] - qpy * e2x[e]);
      const float un = sg * (qpx * e1y[a] - qpy * e1x[a]);
      const float lo = -1e-9f * ad;
      px[s] = q1x[a];
      py[s] = q1y[a];
      if (ad >= 1e-9f && tn >= lo && tn <= ad && un >= lo && un <= ad) {
        // the fast divide: no branch, 2 ulp of t, ~1e-6 m of the point
        const float t = __fdividef(tn, ad);
        px[s] = q1x[a] + t * e1x[a];
        py[s] = q1y[a] + t * e1y[a];
        valid |= 1u << s;
      }
    }
  }

  const int cnt = __popc(valid);
  float inter = 0.f;
  if (cnt >= 3) {
    float mx = 0.f, my = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mx += (valid >> s) & 1u ? px[s] : 0.f;
      my += (valid >> s) & 1u ? py[s] : 0.f;
    }
    mx /= (float)cnt;
    my /= (float)cnt;
    float key[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      key[s] = (valid >> s) & 1u ? pseudo_angle(px[s] - mx, py[s] - my)
                                 : __int_as_float(0x7f800000);  // +inf
    }
#define COMPARE_EXCHANGE(a, b) compare_exchange(key, px, py, a, b);
    SORT24(COMPARE_EXCHANGE)
#undef COMPARE_EXCHANGE
    // the first cnt slots are the ring; its last vertex closes on slot 0
    float tot = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int s2 = s + 1 < kSlots ? s + 1 : 0;
      const float nx = s + 1 < cnt ? px[s2] : px[0];
      const float ny = s + 1 < cnt ? py[s2] : py[0];
      tot += s < cnt ? px[s] * ny - nx * py[s] : 0.f;
    }
    inter = 0.5f * fabsf(tot);
  }

  const float uni = R[kArea] + C[kArea] - inter;
  return uni > 1e-9f ? inter / uni : 0.f;
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
rotated_iou_kernel(const float* __restrict__ corners1,
                   const float* __restrict__ corners2,
                   float* __restrict__ out, int n, int m) {
  __shared__ float rows[kRows * kStride];
  __shared__ float cols[kCols * kStride];
  // surviving pairs of the tile, (row << 5) | column
  __shared__ unsigned short queue[kRows * kCols];
  __shared__ int queued;

  // a tile's rows are strided over the matrix, its columns contiguous
  const int b = blockIdx.z;
  const int row0 = blockIdx.y;
  const int row_step = gridDim.y;
  const int col0 = blockIdx.x * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) queued = 0;
  if (threadIdx.x < kRows + kCols) {
    const bool is_row = threadIdx.x < kRows;
    const int r = is_row ? threadIdx.x : threadIdx.x - kRows;
    const int idx = is_row ? row0 + r * row_step : col0 + r;
    const int lim = is_row ? n : m;
    const float* src = is_row ? corners1 + ((size_t)b * n + idx) * 8
                              : corners2 + ((size_t)b * m + idx) * 8;
    stage_box(src, idx < lim, (is_row ? rows : cols) + r * kStride);
  }
  __syncthreads();

  float* out_b = out + (size_t)b * n * m;
  const int j = col0 + lane;
  const float* C = cols + lane * kStride;
  const float ccx = C[kCX], ccy = C[kCY], creach = C[kReach];

  // 1. the cull: cleared pairs are stored now, survivors are queued
  unsigned survive[kRowsPerWarp];
  int total = 0;
#pragma unroll
  for (int s = 0; s < kRowsPerWarp; ++s) {
    const int r = warp + s * kWarps;
    const int i = row0 + r * row_step;
    const float* R = rows + r * kStride;
    const float dx = R[kCX] - ccx;
    const float dy = R[kCY] - ccy;
    const float reach = R[kReach] + creach;
    const bool live = i < n && j < m;
    const bool cleared = dx * dx + dy * dy > reach * reach;
    if (live && cleared) out_b[(size_t)i * m + j] = 0.f;
    survive[s] = __ballot_sync(0xffffffffu, live && !cleared);
    total += __popc(survive[s]);
  }
  int base = 0;
  if (lane == 0 && total > 0) base = atomicAdd(&queued, total);
  base = __shfl_sync(0xffffffffu, base, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kRowsPerWarp; ++s) {
    if ((survive[s] >> lane) & 1u) {
      const int r = warp + s * kWarps;
      queue[base + __popc(survive[s] & below)] =
          (unsigned short)((r << 5) | lane);
    }
    base += __popc(survive[s]);
  }
  __syncthreads();

  // 2. the survivors, taken by the whole block in strides
  const int count = queued;
  for (int q = threadIdx.x; q < count; q += kWarps * 32) {
    const int r = queue[q] >> 5;
    const int c = queue[q] & 31;
    out_b[(size_t)(row0 + r * row_step) * m + col0 + c] =
        pair_iou(rows + r * kStride, cols + c * kStride);
  }
}

}  // namespace

extern "C" int rotated_iou_launch(const float* corners1, const float* corners2,
                                  float* out, int batch, int n, int m,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 block(kWarps * 32);
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows, batch);
  rotated_iou_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      corners1, corners2, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
