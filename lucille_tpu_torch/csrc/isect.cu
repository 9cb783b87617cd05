// Dense closest hit and any-hit of a ray wavefront against a Morton-sorted
// triangle soup, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of lucille_tpu/accel/pallas_isect.py:
//   * _isect_kernel (:57), behind pallas_closest_hit: per ray the nearest
//     hit with 0 < t, Moller-Trumbore with |det| > 1e-14, u, v >= 0,
//     u + v <= 1; among equal t the lowest triangle index wins; misses
//     report t = +inf, u = v = 0, tri = -1.  An optional `active` mask
//     marks the live rays of a bounce wavefront; a dead ray does no work
//     and reports a miss.
//   * _anyhit_kernel (:390), behind pallas_any_hit: per ray whether any
//     triangle is hit with 0 < t < tmax (per-ray tmax, +inf unbounded),
//     by the same Moller-Trumbore test; an optional `active` mask marks the
//     live rays, and a dead ray does no work and reports "not occluded".
//
// What bounds them on the H100: f32 ALU work per ray-triangle pair (~45
// operations and one IEEE divide).  A scene of <= 16384 triangles is at
// most 1 MB of packed triangles and sits in L2, so memory traffic is
// small next to the arithmetic.
//
// What the design does about it:
//   * one thread per ray, 256 rays per block; rays never leave registers;
//   * triangles are staged one 128-triangle tile at a time in shared
//     memory, where every lane of a warp reads the same word (a broadcast);
//   * before a tile, each ray runs the slab test against the tile's box
//     (bounded by its own running t, or its tmax for the any-hit).  A block
//     stages a tile only if some ray of it reaches the box, and a warp
//     tests the tile only if some lane of it does (warp-uniform control
//     flow), so the cull skips work at warp granularity.  The closest hit
//     tests a staged tile with every lane of such a warp, as the TPU
//     kernel's block does; the any-hit drops a ray at its first hit, and a
//     ray that is dead or already occluded neither reaches a box nor tests;
//   * neither kernel needs a lane order for its active mask: lucille_tpu
//     compacts live rays to the front so that whole blocks can skip, but a
//     dead ray here reaches no box, so dead rays stay where they are and
//     cost one mask read (a warp or block of dead rays stages and tests
//     nothing);
//   * counters (closest hit only): ntile[w] is the number of tiles warp w
//     tested; a tested tile is 128 x 32 ray-triangle tests.  The any-hit
//     counts nothing, as lucille_tpu's does not.
//
// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twins (accel/isect.py: closest_hit_reference,
// any_hit_reference).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 128;      // triangles per tile
constexpr int BLOCK = 256;   // rays per block
constexpr float DET_EPS = 1e-14f;

__device__ __forceinline__ float bounded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, invx, invy, invz;

  __device__ __forceinline__ void load(const float* __restrict__ org,
                                       const float* __restrict__ dir, int i,
                                       bool live) {
    ox = oy = oz = dx = dy = 0.f;
    dz = 1.f;
    if (live) {
      ox = org[3 * i + 0];
      oy = org[3 * i + 1];
      oz = org[3 * i + 2];
      dx = dir[3 * i + 0];
      dy = dir[3 * i + 1];
      dz = dir[3 * i + 2];
    }
    invx = bounded_inv(dx);
    invy = bounded_inv(dy);
    invz = bounded_inv(dz);
  }

  // does the ray reach tile k's box before t_lim?  Rows of `boxes` are
  // [min xyz | max xyz] over n_tiles columns.
  __device__ __forceinline__ bool reaches(const float* __restrict__ boxes,
                                          int n_tiles, int k,
                                          float t_lim) const {
    const float t0x = (boxes[0 * n_tiles + k] - ox) * invx;
    const float t1x = (boxes[3 * n_tiles + k] - ox) * invx;
    const float t0y = (boxes[1 * n_tiles + k] - oy) * invy;
    const float t1y = (boxes[4 * n_tiles + k] - oy) * invy;
    const float t0z = (boxes[2 * n_tiles + k] - oz) * invz;
    const float t1z = (boxes[5 * n_tiles + k] - oz) * invz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return tn <= tf && tf > 0.f && tn < t_lim;
  }

  // Moller-Trumbore against triangle j of the staged tile: a hit with
  // 0 < t < t_lim, writing t, u, v.
  __device__ __forceinline__ bool hits(const float (*s)[TC], int j,
                                       float t_lim, float& t, float& u,
                                       float& v) const {
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
    u = (sx * px + sy * py + sz * pz) * inva;
    v = (qx * dx + qy * dy + qz * dz) * inva;
    t = (e2x * qx + e2y * qy + e2z * qz) * inva;
    return valid && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
           t > 0.f && t < t_lim;
  }
};

// all threads of the block copy tile k (v0, e1, e2) into shared memory
__device__ __forceinline__ void stage_tile(float (*s)[TC],
                                           const float* __restrict__ tris,
                                           int npad, int k) {
  for (int e = threadIdx.x; e < 9 * TC; e += BLOCK) {
    const int r = e / TC, c = e - r * TC;
    s[r][c] = tris[(size_t)r * npad + (size_t)k * TC + c];
  }
}

__global__ void __launch_bounds__(BLOCK)
closest_hit_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                   const unsigned char* __restrict__ active, int B,
                   const float* __restrict__ tris, int npad,
                   const float* __restrict__ boxes, int n_tiles,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ tri_out,
                   int* __restrict__ ntile_out) {
  __shared__ float s[9][TC];  // v0, e1, e2 of one tile, component-major

  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B && (active == nullptr || active[i] != 0);
  Ray ray;
  ray.load(org, dir, i, live);

  // a dead ray's bound of 0 admits no hit in a tile its warp tests
  float t_best = live ? INFINITY : 0.f, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  int ntested = 0;

  for (int k = 0; k < n_tiles; ++k) {
    const bool reach = live && ray.reaches(boxes, n_tiles, k, t_best);
    if (!__syncthreads_or(reach)) continue;  // block-uniform
    stage_tile(s, tris, npad, k);
    __syncthreads();

    if (__any_sync(0xffffffffu, reach)) {  // warp-uniform
      ++ntested;
      for (int j = 0; j < TC; ++j) {
        float t, u, v;
        // strict t < t_best in index order: the lowest index wins ties
        if (ray.hits(s, j, t_best, t, u, v)) {
          t_best = t;
          u_best = u;
          v_best = v;
          tri_best = k * TC + j;
        }
      }
    }
    __syncthreads();
  }

  if (i < B) {
    t_out[i] = live ? t_best : INFINITY;
    u_out[i] = u_best;
    v_out[i] = v_best;
    tri_out[i] = tri_best;
  }
  if ((threadIdx.x & 31) == 0) ntile_out[i >> 5] = ntested;
}

__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ org, const float* __restrict__ dir,
               const float* __restrict__ tmax,
               const unsigned char* __restrict__ active, int B,
               const float* __restrict__ tris, int npad,
               const float* __restrict__ boxes, int n_tiles,
               unsigned char* __restrict__ occ_out) {
  __shared__ float s[9][TC];  // v0, e1, e2 of one tile, component-major

  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B && (active == nullptr || active[i] != 0);
  Ray ray;
  ray.load(org, dir, i, live);
  const float t_lim = live ? tmax[i] : 0.f;

  bool occ = false;
  for (int k = 0; k < n_tiles; ++k) {
    const bool reach = live && !occ && ray.reaches(boxes, n_tiles, k, t_lim);
    if (!__syncthreads_or(reach)) continue;  // block-uniform
    stage_tile(s, tris, npad, k);
    __syncthreads();

    if (__any_sync(0xffffffffu, reach)) {  // warp-uniform
      // each live, unoccluded lane of the warp stops at its first hit
      for (int j = 0; j < TC && live && !occ; ++j) {
        float t, u, v;
        occ = ray.hits(s, j, t_lim, t, u, v);
      }
    }
    __syncthreads();
  }
  if (i < B) occ_out[i] = occ ? 1 : 0;
}

}  // namespace

// active: B bytes (non-zero = live) or null (every ray live)
extern "C" int lt_closest_hit(const float* org, const float* dir,
                              const unsigned char* active, int B,
                              const float* tris, int npad, const float* boxes,
                              int n_tiles, float* t, float* u, float* v,
                              int* tri, int* ntile, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  closest_hit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, active, B, tris, npad, boxes, n_tiles, t, u, v, tri, ntile);
  return static_cast<int>(cudaGetLastError());
}

// active: B bytes (non-zero = live) or null (every ray live)
extern "C" int lt_any_hit(const float* org, const float* dir,
                          const float* tmax, const unsigned char* active,
                          int B, const float* tris, int npad,
                          const float* boxes, int n_tiles, unsigned char* occ,
                          void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  any_hit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, active, B, tris, npad, boxes, n_tiles, occ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
