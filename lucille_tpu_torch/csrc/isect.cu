// Dense closest hit of a ray wavefront against a Morton-sorted triangle
// soup, hand-written for Hopper (sm_90a).
//
// Replaces: lucille_tpu/accel/pallas_isect.py:_isect_kernel (:57), the
// Pallas TPU kernel behind pallas_closest_hit.  Same contract: per ray the
// nearest hit with 0 < t, Moller-Trumbore with |det| > 1e-14, u, v >= 0,
// u + v <= 1; among equal t the lowest triangle index wins; misses report
// t = +inf, u = v = 0, tri = -1.
//
// What bounds it on the H100: f32 ALU work per ray-triangle pair (~45
// operations and one IEEE divide).  A scene of <= 16384 triangles is at
// most 1 MB of packed triangles and sits in L2, so memory traffic is
// small next to the arithmetic.
//
// What the design does about it:
//   * one thread per ray, 256 rays per block; rays never leave registers;
//   * triangles are staged one 128-triangle tile at a time in shared
//     memory, where every lane of a warp reads the same word (a broadcast);
//   * before a tile, each ray runs the slab test against the tile's box
//     and its own running t.  A block stages a tile only if some ray of
//     it reaches the box, and a warp tests the tile only if some lane of
//     it does (warp-uniform control flow; lanes that cannot reach the
//     box still test it when a neighbour does, as the TPU kernel's block
//     does), so the cull skips work at warp granularity.
//   * counters: ntile[w] is the number of tiles warp w tested; a tested
//     tile is 128 x 32 ray-triangle tests.
//
// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twin (accel/isect.py: closest_hit_reference).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 128;      // triangles per tile
constexpr int BLOCK = 256;   // rays per block
constexpr float DET_EPS = 1e-14f;

__device__ __forceinline__ float bounded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

__global__ void __launch_bounds__(BLOCK)
closest_hit_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                   int B, const float* __restrict__ tris, int npad,
                   const float* __restrict__ boxes, int n_tiles,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ tri_out,
                   int* __restrict__ ntile_out) {
  __shared__ float s[9][TC];  // v0, e1, e2 of one tile, component-major

  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (live) {
    ox = org[3 * i + 0];
    oy = org[3 * i + 1];
    oz = org[3 * i + 2];
    dx = dir[3 * i + 0];
    dy = dir[3 * i + 1];
    dz = dir[3 * i + 2];
  }
  const float invx = bounded_inv(dx);
  const float invy = bounded_inv(dy);
  const float invz = bounded_inv(dz);

  float t_best = INFINITY, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  int ntested = 0;

  for (int k = 0; k < n_tiles; ++k) {
    const float t0x = (boxes[0 * n_tiles + k] - ox) * invx;
    const float t1x = (boxes[3 * n_tiles + k] - ox) * invx;
    const float t0y = (boxes[1 * n_tiles + k] - oy) * invy;
    const float t1y = (boxes[4 * n_tiles + k] - oy) * invy;
    const float t0z = (boxes[2 * n_tiles + k] - oz) * invz;
    const float t1z = (boxes[5 * n_tiles + k] - oz) * invz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const bool reach = live && tn <= tf && tf > 0.f && tn < t_best;
    if (!__syncthreads_or(reach)) continue;  // block-uniform

    for (int e = threadIdx.x; e < 9 * TC; e += BLOCK) {
      const int r = e / TC, c = e - r * TC;
      s[r][c] = tris[(size_t)r * npad + (size_t)k * TC + c];
    }
    __syncthreads();

    if (__any_sync(0xffffffffu, reach)) {  // warp-uniform
      ++ntested;
      for (int j = 0; j < TC; ++j) {
        const float v0x = s[0][j], v0y = s[1][j], v0z = s[2][j];
        const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
        const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float a = e1x * px + e1y * py + e1z * pz;
        const bool valid = fabsf(a) > DET_EPS;
        const float inva = valid ? 1.0f / a : 0.0f;
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float u = (sx * px + sy * py + sz * pz) * inva;
        const float v = (qx * dx + qy * dy + qz * dz) * inva;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inva;
        // strict t < t_best in index order: the lowest index wins ties
        if (valid && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
            t > 0.f && t < t_best) {
          t_best = t;
          u_best = u;
          v_best = v;
          tri_best = k * TC + j;
        }
      }
    }
    __syncthreads();
  }

  if (live) {
    t_out[i] = t_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
    tri_out[i] = tri_best;
  }
  if ((threadIdx.x & 31) == 0) ntile_out[i >> 5] = ntested;
}

}  // namespace

extern "C" int lt_closest_hit(const float* org, const float* dir, int B,
                              const float* tris, int npad, const float* boxes,
                              int n_tiles, float* t, float* u, float* v,
                              int* tri, int* ntile, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  closest_hit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, B, tris, npad, boxes, n_tiles, t, u, v, tri, ntile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
