// Tile-BVH closest hit and any-hit of a ray wavefront, hand-written for
// Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of lucille_tpu/accel/pallas_bvh.py:
//   * _bvh_closest_kernel (:310), behind pallas_bvh_closest_hit: per ray
//     the nearest hit with 0 < t < tmax, Moller-Trumbore with |det| > 1e-14,
//     u, v >= 0, u + v <= 1; a miss reports t = tmax, u = v = 0, tri = -1.
//     An optional `active` mask marks a bounce wavefront's live rays; a
//     dead ray walks nothing and reports a miss (lucille_tpu's walk ignores
//     the mask; the answers do not depend on it).
//   * _bvh_anyhit_kernel (:598), behind pallas_bvh_any_hit and the
//     cone-tiled AO gather: per ray whether any triangle is hit with
//     0 < t < tmax, by the division-free signed-volume test.
//   * _bvh_ao_kernel (:810), behind _pallas_bvh_ao_occlusion (:1273,
//     LUCILLE_BVH_AO=fused): the fused AO gather.  For each compacted hit
//     slot below the live count and each of its S stratified directions
//     (the R2-rotated jitter of accel/ao.stratum_directions), whether the
//     unbounded ray from the slot's shading point hits anything (the same
//     signed-volume test, t a > 0); the slot's count of occluded strata.
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
// The fused AO gather (bvh_ao_kernel) is what the TPU walked once per
// (256-lane block, stratum) with an any() over the block, a vector-unit
// shape.  Here a thread walks one (slot, stratum) ray:
//   * the walk is stackless: a node's skip link (the node after its
//     subtree, lucille_tpu's nmeta row 0) is where a missed box or a tested
//     leaf goes on, an entered inner node goes to its first child, so the
//     walk keeps one node index and no stack;
//   * a warp is G = 32 / K neighbouring slots (Morton-sorted shading points)
//     x K cone-adjacent strata (the `perm` runs of accel/bvh_ao.py), the
//     layout of the cone-tiled gather, so its 32 rays agree on the path; a
//     block of up to 8 warps holds the same G slots and takes the stratum
//     runs in turn;
//   * the S x B gather rays are never written to memory: each thread builds
//     its direction in registers from the slot's basis and jitter;
//   * each thread counts its own occluded strata; the block sums a slot's
//     counts in a fixed order through shared memory, with no atomics;
//   * the live-slot count stays on the device and is read by the kernel; a
//     block wholly at or past it writes zeros and exits.
// Its counters: stats[2b] and stats[2b + 1] are the node visits and leaf
// tiles tested by block b's walks.
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
constexpr int AO_THREADS = 256;  // the fused gather's largest block
constexpr float R2_A1 = 0.7548776662466927f;
constexpr float R2_A2 = 0.5698402909980532f;
constexpr float TWO_PI = 6.283185307179586f;

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

  // the division-free signed-volume any-hit against slot k of the pack:
  // u' + v' + w' = a, so inside is a same-sign test, and t'/a in (0, tmax)
  // becomes t'a > 0 and (BOUNDED) t'a < tmax a^2 (a^2 > 0)
  template <bool BOUNDED>
  __device__ __forceinline__ bool occludes(const float* __restrict__ tris,
                                           int npad, int k,
                                           float tmax) const {
    const float v0x = __ldg(&tris[0 * (size_t)npad + k]);
    const float v0y = __ldg(&tris[1 * (size_t)npad + k]);
    const float v0z = __ldg(&tris[2 * (size_t)npad + k]);
    const float e1x = __ldg(&tris[3 * (size_t)npad + k]);
    const float e1y = __ldg(&tris[4 * (size_t)npad + k]);
    const float e1z = __ldg(&tris[5 * (size_t)npad + k]);
    const float e2x = __ldg(&tris[6 * (size_t)npad + k]);
    const float e2y = __ldg(&tris[7 * (size_t)npad + k]);
    const float e2z = __ldg(&tris[8 * (size_t)npad + k]);
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float a = e1x * px + e1y * py + e1z * pz;
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float u = sx * px + sy * py + sz * pz;
    const float v = qx * dx + qy * dy + qz * dz;
    const float w = a - u - v;
    const float t = e2x * qx + e2y * qy + e2z * qz;
    const bool inside = fminf(fminf(u, v), w) >= 0.f ||
                        fmaxf(fmaxf(u, v), w) <= 0.f;
    const float ta = t * a;
    return inside && ta > 0.f && (!BOUNDED || ta < tmax * (a * a)) &&
           fabsf(a) > DET_EPS;
  }
};

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float* __restrict__ org, const float* __restrict__ dir,
           const float* __restrict__ tmax_in,
           const unsigned char* __restrict__ active, int B,
           const float* __restrict__ tris, int npad,
           const float4* __restrict__ nodes, float* __restrict__ t_out,
           float* __restrict__ u_out, float* __restrict__ v_out,
           int* __restrict__ tri_out, bool* __restrict__ occ_out,
           int* __restrict__ stats) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B && (active == nullptr || active[i] != 0);
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f};
  const float tmax = i < B ? tmax_in[i] : 0.f;  // a dead ray reports it
  if (live) {
    r.ox = org[3 * i + 0];
    r.oy = org[3 * i + 1];
    r.oz = org[3 * i + 2];
    r.dx = dir[3 * i + 0];
    r.dy = dir[3 * i + 1];
    r.dz = dir[3 * i + 2];
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
        if constexpr (ANY) {
          if (r.occludes<true>(tris, npad, k, tmax)) {
            occluded = true;
            break;
          }
        } else {
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

  if (i < B) {
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

// The fused AO gather.  Block b holds slots [b G, b G + G) (G = 32 / K);
// lane l of each of its warps is slot g = l % G at run offset k = l / G,
// and warp w walks stratum runs w, w + nwarps, ... (run r is strata
// perm[r K .. r K + K)).  rays (12, B) [P_off | b0 | b1 | b2] and jitter
// (2, B) are in compacted order; nact[0] is the live-slot count.
__global__ void __launch_bounds__(AO_THREADS)
bvh_ao_kernel(const float* __restrict__ rays, const float* __restrict__ jit,
              int B, const int* __restrict__ nact,
              const float* __restrict__ tris, int npad,
              const float4* __restrict__ nodes, const int* __restrict__ skip,
              int n_nodes, const int* __restrict__ perm, int S, int K,
              int ntheta, float inv_nt, float inv_np,
              float* __restrict__ occ_out, int* __restrict__ stats) {
  __shared__ int counts[AO_THREADS];
  __shared__ int vis[AO_THREADS / 32], tiles[AO_THREADS / 32];
  const int G = 32 / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane % G, k = lane / G;
  const int slot = blockIdx.x * G + g;
  const int n_live = min(nact[0], B);
  if (blockIdx.x * G >= n_live) {  // a block of dead slots: no work
    if (threadIdx.x < G && slot < B) occ_out[slot] = 0.f;
    if (threadIdx.x == 0) stats[2 * blockIdx.x] = stats[2 * blockIdx.x + 1] = 0;
    return;
  }
  const bool live = slot < n_live;
  int occluded = 0, nvis = 0, ntiles = 0;
  if (live) {
    float b[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) b[c] = rays[(size_t)(c + 3) * B + slot];
    Ray r{rays[slot], rays[(size_t)B + slot], rays[(size_t)2 * B + slot],
          0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float u0l = jit[slot], u1l = jit[(size_t)B + slot];
    for (int run = warp; run < S / K; run += nwarps) {
      // the stratum's direction: accel/ao.stratum_directions' f32 chain
      const int st = perm[run * K + k];
      const float sf = (float)st;
      const float sh0 = sf * R2_A1;
      const float sh1 = sf * R2_A2;
      float u0 = u0l + (sh0 - floorf(sh0));
      u0 = u0 - floorf(u0);
      float u1 = u1l + (sh1 - floorf(sh1));
      u1 = u1 - floorf(u1);
      const float fi = (float)(st % ntheta);
      const float fj = (float)(st / ntheta);
      const float z0 = (fi + u0) * inv_nt;
      const float z1 = (fj + u1) * inv_np;
      const float cos_t = sqrtf(z0);
      const float phi = TWO_PI * z1;
      const float lx = cosf(phi) * cos_t;
      const float ly = sinf(phi) * cos_t;
      const float lz = sqrtf(fmaxf(1.0f - z0, 0.0f));
      r.dx = lx * b[0] + ly * b[3] + lz * b[6];
      r.dy = lx * b[1] + ly * b[4] + lz * b[7];
      r.dz = lx * b[2] + ly * b[5] + lz * b[8];
      r.ivx = bounded_inv(r.dx);
      r.ivy = bounded_inv(r.dy);
      r.ivz = bounded_inv(r.dz);
      // the stackless walk: enter a reached inner node's first child, else
      // go on at the node's skip link
      bool hit = false;
      for (int node = 0; node < n_nodes && !hit;) {
        ++nvis;
        float tn, tf;
        r.slab(nodes, node, tn, tf);
        const bool reach = tn <= tf && tf > 0.f;
        const int meta = __float_as_int(__ldg(&nodes[2 * node]).w);
        if (reach && meta > 0) {  // a leaf: tiles [link, link + meta)
          const int link = __float_as_int(__ldg(&nodes[2 * node + 1]).w);
          ntiles += meta;
          const int end = (link + meta) * TC;
          for (int q = link * TC; q < end && !hit; ++q)
            hit = r.occludes<false>(tris, npad, q, 0.f);
        }
        node = (reach && meta <= 0) ? node + 1 : __ldg(&skip[node]);
      }
      occluded += hit;
    }
  }
  counts[threadIdx.x] = occluded;
  const int wvis = __reduce_add_sync(0xffffffffu, nvis);
  const int wtiles = __reduce_add_sync(0xffffffffu, ntiles);
  if (lane == 0) {
    vis[warp] = wvis;
    tiles[warp] = wtiles;
  }
  __syncthreads();
  if (threadIdx.x < G && slot < B) {  // a slot's strata, in a fixed order
    int total = 0;
    for (int w = 0; w < nwarps; ++w)
      for (int kk = 0; kk < K; ++kk) total += counts[w * 32 + kk * G + g];
    occ_out[slot] = (float)total;
  }
  if (threadIdx.x == 0) {
    int sv = 0, st = 0;
    for (int w = 0; w < nwarps; ++w) {
      sv += vis[w];
      st += tiles[w];
    }
    stats[2 * blockIdx.x] = sv;
    stats[2 * blockIdx.x + 1] = st;
  }
}

}  // namespace

// active: B bytes (non-zero = live) or null (every ray live)
extern "C" int lt_bvh_closest_hit(const float* org, const float* dir,
                                  const float* tmax,
                                  const unsigned char* active, int B,
                                  const float* tris, int npad,
                                  const void* nodes, float* t, float* u,
                                  float* v, int* tri, int* stats,
                                  void* stream) {
  if (B <= 0) return 0;
  bvh_kernel<false><<<grid_for(B), BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, active, B, tris, npad,
      static_cast<const float4*>(nodes), t, u, v, tri, nullptr, stats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lt_bvh_any_hit(const float* org, const float* dir,
                              const float* tmax, int B, const float* tris,
                              int npad, const void* nodes, bool* occ,
                              int* stats, void* stream) {
  if (B <= 0) return 0;
  bvh_kernel<true><<<grid_for(B), BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, nullptr, B, tris, npad,
      static_cast<const float4*>(nodes), nullptr, nullptr, nullptr, nullptr,
      occ, stats);
  return static_cast<int>(cudaGetLastError());
}

// K strata per warp (K divides 32 and S), warps per block (1-8, at most
// S / K); stats: 2 ints per block of G = 32 / K slots
extern "C" int lt_bvh_ao_fused(const float* rays, const float* jitter, int B,
                               const int* nact, const float* tris, int npad,
                               const void* nodes, const int* skip,
                               int n_nodes, const int* perm, int S, int K,
                               int warps, int ntheta, float inv_ntheta,
                               float inv_nphi, float* occ, int* stats,
                               void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || 32 % K || S % K || warps < 1 || warps * 32 > AO_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 32 / K;
  bvh_ao_kernel<<<(B + G - 1) / G, warps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      rays, jitter, B, nact, tris, npad, static_cast<const float4*>(nodes),
      skip, n_nodes, perm, S, K, ntheta, inv_ntheta, inv_nphi, occ, stats);
  return static_cast<int>(cudaGetLastError());
}
