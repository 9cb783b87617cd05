// Tile-BVH closest hit and any-hit of a ray wavefront, hand-written for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of lucille_tpu/accel/pallas_bvh.py:
//   * _bvh_closest_kernel (:310), behind pallas_bvh_closest_hit: per ray
//     the nearest hit with 0 < t < tmax, Moller-Trumbore with |det| > 1e-14,
//     u, v >= 0, u + v <= 1; a miss reports t = tmax, u = v = 0, tri = -1.
//   * _bvh_anyhit_kernel (:598), behind pallas_bvh_any_hit and the
//     cone-tiled AO gather: per ray whether any triangle is hit with
//     0 < t < tmax, by the division-free signed-volume test.
// The tree is lucille_tpu's tile BVH (accel/tile_bvh.py): its leaves are
// runs of whole 128-triangle tiles of the (16, npad) [v0 | e1 | e2] pack,
// its nodes the (M, 8) pack of accel/pack.py:pack_nodes.
//
// What bounds it on the H100: every thread walks its own ray through the
// tree, so a warp diverges wherever its rays disagree about the next node,
// and every leaf visit reads 128 triangles of 36 bytes from L2 or HBM (the
// 1M-triangle heightfield's pack is 97 MB, twice the 50 MB L2).
//
// What the simple design does about that:
//   * one thread per ray, 128 rays per block, the ray in registers and a
//     64-entry stack per thread in local memory (the wrapper refuses a tree
//     deeper than that, so the stack never overflows);
//   * ordered descent: both children of an inner node are slab-tested and
//     the one nearer along this ray's direction on the node's split axis is
//     entered first, the other pushed.  The closest hit reaches a child
//     only if its entry distance is below the running t, and pops a pushed
//     child only if it still is; the any-hit thread stops at its first hit;
//   * the callers order their rays so that a warp's 32 rays are neighbours
//     (eye rays by pixel; gather rays 8 origins x 4 strata of one cone,
//     accel/bvh_ao.py), so a warp mostly visits the same leaves and its
//     triangle loads are broadcasts of one address;
//   * counters: stats[2w] and stats[2w + 1] are the node visits and the leaf
//     tiles tested by warp w's rays.  There is no tile cache, so nothing
//     counts as a miss.
//
// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twins (accel/bvh_isect.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 128;     // triangles per tile
constexpr int BLOCK = 128;  // rays per block
constexpr int STACK = 64;   // per-thread stack entries (bvh_isect.STACK)
constexpr float DET_EPS = 1e-14f;

__device__ __forceinline__ float bounded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;

  // entry and exit distance of the ray through a node's box
  __device__ __forceinline__ void slab(const float4* __restrict__ nodes,
                                       int n, float& tn, float& tf) const {
    const float4 lo = __ldg(&nodes[2 * n]);
    const float4 hi = __ldg(&nodes[2 * n + 1]);
    const float t0x = (lo.x - ox) * ivx;
    const float t1x = (hi.x - ox) * ivx;
    const float t0y = (lo.y - oy) * ivy;
    const float t1y = (hi.y - oy) * ivy;
    const float t0z = (lo.z - oz) * ivz;
    const float t1z = (hi.z - oz) * ivz;
    tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  }
};

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float* __restrict__ org, const float* __restrict__ dir,
           const float* __restrict__ tmax_in, int B,
           const float* __restrict__ tris, int npad,
           const float4* __restrict__ nodes, float* __restrict__ t_out,
           float* __restrict__ u_out, float* __restrict__ v_out,
           int* __restrict__ tri_out, bool* __restrict__ occ_out,
           int* __restrict__ stats) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f};
  float tmax = 0.f;
  if (live) {
    r.ox = org[3 * i + 0];
    r.oy = org[3 * i + 1];
    r.oz = org[3 * i + 2];
    r.dx = dir[3 * i + 0];
    r.dy = dir[3 * i + 1];
    r.dz = dir[3 * i + 2];
    tmax = tmax_in[i];
  }
  r.ivx = bounded_inv(r.dx);
  r.ivy = bounded_inv(r.dy);
  r.ivz = bounded_inv(r.dz);

  float t_best = tmax, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  bool occluded = false;
  int nvis = 0, ntiles = 0;
  int stack[STACK];
  float stack_tn[ANY ? 1 : STACK];  // closest hit: the pushed child's entry
  int sp = 0;
  int cur = live ? 0 : -1;  // the root is entered unconditionally

  while (cur >= 0) {
    ++nvis;
    const int meta = __float_as_int(__ldg(&nodes[2 * cur]).w);
    const int link = __float_as_int(__ldg(&nodes[2 * cur + 1]).w);
    int next = -1;
    if (meta > 0) {  // leaf: tiles [link, link + meta)
      ntiles += meta;
      const int end = (link + meta) * TC;
      for (int k = link * TC; k < end; ++k) {
        const float v0x = __ldg(&tris[0 * (size_t)npad + k]);
        const float v0y = __ldg(&tris[1 * (size_t)npad + k]);
        const float v0z = __ldg(&tris[2 * (size_t)npad + k]);
        const float e1x = __ldg(&tris[3 * (size_t)npad + k]);
        const float e1y = __ldg(&tris[4 * (size_t)npad + k]);
        const float e1z = __ldg(&tris[5 * (size_t)npad + k]);
        const float e2x = __ldg(&tris[6 * (size_t)npad + k]);
        const float e2y = __ldg(&tris[7 * (size_t)npad + k]);
        const float e2z = __ldg(&tris[8 * (size_t)npad + k]);
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float a = e1x * px + e1y * py + e1z * pz;
        const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        if constexpr (ANY) {
          // u' + v' + w' = a: inside is a same-sign test, and t'/a in
          // (0, tmax) becomes t'a > 0 and t'a < tmax a^2 (a^2 > 0)
          const float u = sx * px + sy * py + sz * pz;
          const float v = qx * r.dx + qy * r.dy + qz * r.dz;
          const float w = a - u - v;
          const float t = e2x * qx + e2y * qy + e2z * qz;
          const bool inside = fminf(fminf(u, v), w) >= 0.f ||
                              fmaxf(fmaxf(u, v), w) <= 0.f;
          const float ta = t * a;
          if (inside && ta > 0.f && ta < tmax * (a * a) &&
              fabsf(a) > DET_EPS) {
            occluded = true;
            break;
          }
        } else {
          const bool valid = fabsf(a) > DET_EPS;
          const float inva = valid ? 1.0f / a : 0.0f;
          const float u = (sx * px + sy * py + sz * pz) * inva;
          const float v = (qx * r.dx + qy * r.dy + qz * r.dz) * inva;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inva;
          // strict t < t_best in slot order: the lowest slot of a leaf
          // wins a tie inside it
          if (valid && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
              t > 0.f && t < t_best) {
            t_best = t;
            u_best = u;
            v_best = v;
            tri_best = k;
          }
        }
      }
      if (ANY && occluded) break;
    } else {  // inner: children cur + 1 and link, split axis -meta - 1
      const int c0 = cur + 1, c1 = link;
      float tn0, tf0, tn1, tf1;
      r.slab(nodes, c0, tn0, tf0);
      r.slab(nodes, c1, tn1, tf1);
      const float bound = ANY ? tmax : t_best;
      const bool r0 = tn0 <= tf0 && tf0 > 0.f && tn0 < bound;
      const bool r1 = tn1 <= tf1 && tf1 > 0.f && tn1 < bound;
      const int axis = -meta - 1;
      const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
      const bool near0 = d >= 0.f;  // child 0 lies on the low side
      const bool reach_near = near0 ? r0 : r1;
      const bool reach_far = near0 ? r1 : r0;
      const int near = near0 ? c0 : c1, far = near0 ? c1 : c0;
      if (reach_near && reach_far) {
        stack[sp] = far;
        if constexpr (!ANY) stack_tn[sp] = near0 ? tn1 : tn0;
        ++sp;
        next = near;
      } else if (reach_near) {
        next = near;
      } else if (reach_far) {
        next = far;
      }
    }
    while (next < 0 && sp > 0) {
      --sp;
      if (ANY || stack_tn[ANY ? 0 : sp] < t_best) next = stack[sp];
    }
    cur = next;
  }

  if (live) {
    if constexpr (ANY) {
      occ_out[i] = occluded;
    } else {
      t_out[i] = t_best;
      u_out[i] = u_best;
      v_out[i] = v_best;
      tri_out[i] = tri_best;
    }
  }
  const int wvis = __reduce_add_sync(0xffffffffu, nvis);
  const int wtiles = __reduce_add_sync(0xffffffffu, ntiles);
  if ((threadIdx.x & 31) == 0) {
    stats[2 * (i >> 5)] = wvis;
    stats[2 * (i >> 5) + 1] = wtiles;
  }
}

int grid_for(int B) { return (B + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int lt_bvh_closest_hit(const float* org, const float* dir,
                                  const float* tmax, int B, const float* tris,
                                  int npad, const void* nodes, float* t,
                                  float* u, float* v, int* tri, int* stats,
                                  void* stream) {
  if (B <= 0) return 0;
  bvh_kernel<false><<<grid_for(B), BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, B, tris, npad, static_cast<const float4*>(nodes), t, u,
      v, tri, nullptr, stats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lt_bvh_any_hit(const float* org, const float* dir,
                              const float* tmax, int B, const float* tris,
                              int npad, const void* nodes, bool* occ,
                              int* stats, void* stream) {
  if (B <= 0) return 0;
  bvh_kernel<true><<<grid_for(B), BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, B, tris, npad, static_cast<const float4*>(nodes),
      nullptr, nullptr, nullptr, nullptr, occ, stats);
  return static_cast<int>(cudaGetLastError());
}
