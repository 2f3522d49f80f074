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
// What bounds it on this card: scalar f32 ALU work, a few hundred operations
// per pair (24 candidate tests, 16 crossings with two divides each, a sort of
// up to 24 keys), against 32 bytes of input per box and 4 bytes of output per
// pair (1 MiB at 512 x 512). No tensor-core form exists for it.
//
// What the design does about that: one thread owns one (i, j) pair and keeps
// its candidates in registers and local memory; a 16 x 16 block stages its 16
// row boxes and 16 column boxes in shared memory once (8 floats each, plus the
// box's area, computed once per box instead of once per pair), so the global
// reads are 2 x 16 boxes per 256 pairs. The TPU kernel's 32-slot bitonic
// network was a constraint of its vector compiler; here the <= 24 valid
// candidates are compacted first and insertion-sorted, which does no work for
// the invalid slots. A leading batch dimension is the grid's z axis, so one
// launch covers every frame of a batch.
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

constexpr int kTile = 16;
constexpr int kMaxCand = 24;

// Shoelace area of a quad, relative to its first corner.
__device__ __forceinline__ float ring_area4(const float* x, const float* y) {
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    tot += (x[k] - x[0]) * (y[k2] - y[0]) - (x[k2] - x[0]) * (y[k] - y[0]);
  }
  return 0.5f * fabsf(tot);
}

// Point (px, py) inside the convex quad (qx, qy), either winding.
__device__ __forceinline__ bool in_quad(float px, float py, const float* qx,
                                        const float* qy) {
  bool pos = true;
  bool neg = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    const float ex = qx[k2] - qx[k];
    const float ey = qy[k2] - qy[k];
    const float cr = ex * (py - qy[k]) - ey * (px - qx[k]);
    pos = pos && (cr >= -1e-6f);
    neg = neg && (cr <= 1e-6f);
  }
  return pos || neg;
}

__device__ __forceinline__ float pseudo_angle(float dx, float dy) {
  const float p = dy / (fabsf(dx) + fabsf(dy) + 1e-12f);
  return dx >= 0.f ? p : 2.f - p;
}

__global__ void __launch_bounds__(kTile * kTile)
rotated_iou_kernel(const float* __restrict__ corners1,
                   const float* __restrict__ corners2,
                   float* __restrict__ out, int n, int m) {
  // [box][x0..x3, y0..y3, area]; 9 floats a row keeps the column reads
  // (one box per thread along x) free of bank conflicts
  __shared__ float rows[kTile][9];
  __shared__ float cols[kTile][9];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  if (tid < 2 * kTile) {
    const bool is_row = tid < kTile;
    const int r = is_row ? tid : tid - kTile;
    const int idx = (is_row ? row0 : col0) + r;
    const int lim = is_row ? n : m;
    const float* src = is_row ? corners1 + (size_t)b * n * 8
                              : corners2 + (size_t)b * m * 8;
    float(*dst)[9] = is_row ? rows : cols;
    float x[4], y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = idx < lim ? src[(size_t)idx * 8 + 2 * k] : 0.f;
      y[k] = idx < lim ? src[(size_t)idx * 8 + 2 * k + 1] : 0.f;
      dst[r][k] = x[k];
      dst[r][4 + k] = y[k];
    }
    dst[r][8] = ring_area4(x, y);
  }
  __syncthreads();

  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;
  if (i >= n || j >= m) return;

  // local frame: origin at the row box's first corner
  const float ox = rows[threadIdx.y][0];
  const float oy = rows[threadIdx.y][4];
  float q1x[4], q1y[4], q2x[4], q2y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q1x[k] = rows[threadIdx.y][k] - ox;
    q1y[k] = rows[threadIdx.y][4 + k] - oy;
    q2x[k] = cols[threadIdx.x][k] - ox;
    q2y[k] = cols[threadIdx.x][4 + k] - oy;
  }
  const float a1 = rows[threadIdx.y][8];
  const float a2 = cols[threadIdx.x][8];

  // valid candidates, compacted in the reference's slot order
  float cx[kMaxCand], cy[kMaxCand];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (in_quad(q1x[k], q1y[k], q2x, q2y)) {
      cx[cnt] = q1x[k];
      cy[cnt] = q1y[k];
      ++cnt;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (in_quad(q2x[k], q2y[k], q1x, q1y)) {
      cx[cnt] = q2x[k];
      cy[cnt] = q2y[k];
      ++cnt;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int a2i = (a + 1) & 3;
    const float rx = q1x[a2i] - q1x[a];
    const float ry = q1y[a2i] - q1y[a];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int e2 = (e + 1) & 3;
      const float sx = q2x[e2] - q2x[e];
      const float sy = q2y[e2] - q2y[e];
      const float denom = rx * sy - ry * sx;
      if (fabsf(denom) < 1e-9f) continue;
      const float qpx = q2x[e] - q1x[a];
      const float qpy = q2y[e] - q1y[a];
      const float t = (qpx * sy - qpy * sx) / denom;
      const float u = (qpx * ry - qpy * rx) / denom;
      if (t >= -1e-9f && t <= 1.f + 1e-9f && u >= -1e-9f &&
          u <= 1.f + 1e-9f) {
        cx[cnt] = q1x[a] + t * rx;
        cy[cnt] = q1y[a] + t * ry;
        ++cnt;
      }
    }
  }

  float inter = 0.f;
  if (cnt >= 3) {
    float mx = 0.f, my = 0.f;
    for (int k = 0; k < cnt; ++k) {
      mx += cx[k];
      my += cy[k];
    }
    mx /= (float)cnt;
    my /= (float)cnt;

    float key[kMaxCand];
    for (int k = 0; k < cnt; ++k) {
      key[k] = pseudo_angle(cx[k] - mx, cy[k] - my);
    }
    // insertion sort by key, co-moving the coordinates
    for (int k = 1; k < cnt; ++k) {
      const float kk = key[k], kx = cx[k], ky = cy[k];
      int p = k - 1;
      while (p >= 0 && key[p] > kk) {
        key[p + 1] = key[p];
        cx[p + 1] = cx[p];
        cy[p + 1] = cy[p];
        --p;
      }
      key[p + 1] = kk;
      cx[p + 1] = kx;
      cy[p + 1] = ky;
    }
    float tot = 0.f;
    for (int k = 0; k < cnt; ++k) {
      const int k2 = k + 1 < cnt ? k + 1 : 0;
      tot += cx[k] * cy[k2] - cx[k2] * cy[k];
    }
    inter = 0.5f * fabsf(tot);
  }

  const float uni = a1 + a2 - inter;
  out[((size_t)b * n + i) * m + j] = uni > 1e-9f ? inter / uni : 0.f;
}

}  // namespace

extern "C" int rotated_iou_launch(const float* corners1, const float* corners2,
                                  float* out, int batch, int n, int m,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 block(kTile, kTile);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, batch);
  rotated_iou_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      corners1, corners2, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
