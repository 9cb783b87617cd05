// Tile-BVH closest hit, any-hit and fused AO gather of a ray wavefront,
// hand-written for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of lucille_tpu/accel/pallas_bvh.py:
//   * _bvh_closest_kernel (:310), behind pallas_bvh_closest_hit (kernel
//     4): per ray the nearest hit with 0 < t < tmax, Moller-Trumbore with
//     |det| > 1e-14, u, v >= 0, u + v <= 1; a miss reports t = tmax, u = v
//     = 0, tri = -1.  An optional `active` mask marks a bounce wavefront's
//     live rays; a dead ray walks nothing and reports a miss (lucille_tpu's
//     walk ignores the mask; the answers do not depend on it).
//   * _bvh_anyhit_kernel (:598), behind pallas_bvh_any_hit and the
//     cone-tiled AO gather (kernel 5): per ray whether any triangle is hit
//     with 0 < t < tmax, by the division-free signed-volume test.
//   * _bvh_ao_kernel (:810), behind _pallas_bvh_ao_occlusion (:1273,
//     LUCILLE_BVH_AO=fused; kernel 6): the fused AO gather.  For each
//     compacted hit slot below the live count and each of its S stratified
//     directions (the R2-rotated jitter of accel/ao.stratum_directions),
//     whether the unbounded ray from the slot's shading point hits anything
//     (the same signed-volume test, t a > 0); the slot's count of occluded
//     strata.
// The tree is lucille_tpu's tile BVH (accel/tile_bvh.py): its leaves are
// runs of whole 128-triangle tiles of the (16, npad) [v0 | e1 | e2] pack,
// its nodes the (M, 8) pack of accel/pack.py:pack_nodes; leaf_real (M,)
// holds how many of a leaf's slots are real triangles (they lead the run;
// the rest is padding).
//
// What bounds them on the H100: the work is a data-dependent walk of f32
// slab tests (~25 operations a box) and triangle tests (~58), a few
// hundred million a tile, 0.25-0.46 ms at the f32 peak (PERF.md); the
// bytes (36 a triangle, 97 MB for the 1M-triangle pack, twice the 50 MB
// L2) weigh less.  A walk per thread loses most of that peak: a warp
// serialises wherever its 32 rays disagree on the next node, each thread
// keeps its own stack in local memory, and every triangle test issues nine
// scalar loads, broadcasts only while the warp agrees.
//
// Kernels 5 and 6 therefore walk once per warp (warp_walk):
//   * the warp holds one node index and a near-first stack of (node, the
//     lanes that reach it) pairs, uniform across the warp and kept in
//     registers: entry e lives in lane e % 32, in its first or second slot,
//     and a pop is two shuffles.  64 entries; the wrappers refuse a deeper
//     tree;
//   * at an inner node every lane that reaches it slab-tests both children
//     for its own ray; ballots say which lanes reach each child; the warp
//     enters the child on the side of the split axis that most of those
//     lanes' directions point to (child 0 on a tie) and pushes the other
//     with its lanes if any lane reaches it;
//   * at a leaf the lanes split its real triangles, and only those
//     (leaf_real; no padding): lane l loads slot base + l of each of the
//     nine rows into registers (coalesced), and the rays of the lanes that
//     reach the leaf and have no occluder yet are broadcast in turn by
//     shuffles, each tested against the 32 triangles at once; a ballot
//     says whether it is occluded.  A leaf's tests thus fill the warp
//     however few of its lanes reach the leaf: a lane's own walk over the
//     triangles (the rays split across lanes, the triangles staged in
//     shared memory) reached a SIMT efficiency of 0.13-0.20 on the
//     heightfield tiles and was 3-6x slower on the H100 (PERF.md);
//   * a lane leaves the walk at its first occluder; a popped entry keeps
//     only the lanes still open, and is dropped when none is; the warp
//     stops when no lane is open.  The answer is an OR over the triangles
//     a ray reaches, so the walk order changes no answer.
// Kernel 5 loads a lane's ray; kernel 6 builds it in registers from the
// slot's basis and jitter.  Counters (NSTAT ints a warp, kernel 5, or a
// block, kernel 6): node visits summed over the lanes that reach the node,
// real triangles tested summed over lanes (a ray against a leaf's chunk
// of up to 32), and the warp's own node visits and triangle steps (a step
// tests one ray against the chunk), so lane tests over 32 x warp steps is
// the walk's SIMT efficiency.
//
// The fused gather's layout: a warp is G = 32 / K neighbouring slots
// (Morton-sorted shading points) x K cone-adjacent strata (the `perm` runs
// of accel/bvh_ao.py), the layout of the cone-tiled gather, so its 32 rays
// agree on the path; a block of up to 8 warps holds the same G slots and
// takes the stratum runs in turn.  The S x B gather rays are never written
// to memory.  Each thread counts its own occluded strata; the block sums a
// slot's counts in a fixed order through shared memory, with no atomics.
// The live-slot count stays on the device and is read by the kernel; a
// block wholly at or past it writes zeros and exits.
//
// Kernel 4, the closest hit, walks one ray with a whole warp.  Its time
// was the serial chain of the longest walks: a grazing ray crosses many
// leaves, and a thread a ray tested their slots one after another (16x
// fewer rays took 85% of the time, PERF.md).  More lanes a ray shorten
// that chain, and one ray a walk keeps the ray's own near-first order.
// Groups of 4, 8, 16 and 32 lanes a ray, and kernel 5's shared walk of 32
// rays with a t per lane, were measured (PERF.md): 32 lanes was the
// fastest on the 1M-triangle tile and on every slice, and within noise of
// 16 on the 130k one.
//   * at an inner node every lane slab-tests both children for the ray
//     (the same arithmetic, so the lanes agree); a child is reached only
//     if tn <= tf, tf > 0 and tn < t_best; the near child (by the ray's
//     direction sign on the split axis) is entered first and the far one
//     pushed with its entry tn, popped only if tn < t_best then.  The
//     children's box loads bring their meta and link words, so a descent
//     loads no node twice;
//   * the stack, as deep as the tree (at most STACK entries; the wrapper
//     refuses a deeper tree), lives in shared memory: an int4 (node, tn,
//     meta, link) an entry, written by lane 0, read by all (a __syncwarp
//     each step orders them);
//   * at a leaf the warp takes its real triangles (leaf_real; padding is
//     never loaded) in chunks of 32 in slot order, lane l slot base + l,
//     the nine loads coalesced; each lane tests its triangle against
//     t_best as the chunk starts, and a min-reduction of t's bits and a
//     ballot pick the chunk's least t, the lowest slot on equal t, which
//     replaces t_best only if nearer: the serial strict t < t_best loop's
//     answer, so the lowest slot of a leaf wins a tie inside it and the
//     first leaf visited a tie across leaves.  u and v come from the
//     winning lane;
//   * an inactive ray's warp walks nothing and reports a miss at tmax.
// Counters (NSTAT ints a ray): node visits, real triangles tested, the
// walk's node visits (its ray's) and leaf chunk steps, so tests over 32 x
// steps is the SIMT efficiency in the leaves.

// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twins (accel/bvh_isect.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 128;      // triangles per tile
constexpr int BLOCK = 128;   // threads per block, kernels 4 and 5
constexpr int STACK = 64;    // stack entries (bvh_isect.STACK)
constexpr int NSTAT = 4;     // warp-walk counters (module comment)
constexpr unsigned FULL = 0xffffffffu;
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

  __device__ __forceinline__ void set_dir(float x, float y, float z) {
    dx = x;
    dy = y;
    dz = z;
    ivx = bounded_inv(x);
    ivy = bounded_inv(y);
    ivz = bounded_inv(z);
  }

  // entry and exit distance of the ray through a node's box
  __device__ __forceinline__ void slab(const float4* __restrict__ nodes,
                                       int n, float& tn, float& tf) const {
    slab(__ldg(&nodes[2 * n]), __ldg(&nodes[2 * n + 1]), tn, tf);
  }

  // the same through the box (lo, hi) already loaded
  __device__ __forceinline__ void slab(const float4& lo, const float4& hi,
                                       float& tn, float& tf) const {
    const float t0x = (lo.x - ox) * ivx;
    const float t1x = (hi.x - ox) * ivx;
    const float t0y = (lo.y - oy) * ivy;
    const float t1y = (hi.y - oy) * ivy;
    const float t0z = (lo.z - oz) * ivz;
    const float t1z = (hi.z - oz) * ivz;
    tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  }

  // the division-free signed-volume any-hit against one triangle (v0, e1,
  // e2): u' + v' + w' = a, so inside is a same-sign test, and t'/a in (0,
  // tmax) becomes t'a > 0 and (BOUNDED) t'a < tmax a^2 (a^2 > 0)
  template <bool BOUNDED>
  __device__ __forceinline__ bool occludes(float v0x, float v0y, float v0z,
                                           float e1x, float e1y, float e1z,
                                           float e2x, float e2y, float e2z,
                                           float tmax) const {
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

// slot k's nine rows of the (16, npad) pack
__device__ __forceinline__ void load_tri(const float* __restrict__ tris,
                                         size_t npad, int k, float (&r)[9]) {
#pragma unroll
  for (int c = 0; c < 9; ++c) r[c] = __ldg(&tris[c * npad + k]);
}

struct WalkStats {
  int visits = 0;   // node visits of the lanes that reach the node
  int tests = 0;    // triangles tested by a lane
  int wvisits = 0;  // the warp's node visits (the same in every lane)
  int wtests = 0;   // the warp's triangle steps (the same in every lane)
};

// One warp's any-hit walk of the tile BVH (module comment).  Every lane of
// the warp calls it together; `live` marks a lane with a ray (r, tmax) to
// trace.  Returns whether this lane's ray is occluded.
template <bool BOUNDED>
__device__ __forceinline__ bool warp_walk(
    const Ray& r, float tmax, bool live, const float* __restrict__ tris,
    int npad, const float4* __restrict__ nodes,
    const int* __restrict__ leaf_real, int lane, WalkStats& st) {
  unsigned open = __ballot_sync(FULL, live);  // lanes with no occluder yet
  bool occluded = false;
  int cur = 0;
  unsigned here = open;  // the lanes that reach cur; the root: every open one
  int sp = 0, sn0 = 0, sn1 = 0;  // the stack: entry e in lane e % 32
  unsigned sm0 = 0, sm1 = 0;
  while (open) {
    const bool mine = (here >> lane) & 1u;
    st.visits += mine;
    ++st.wvisits;
    const int meta = __float_as_int(__ldg(&nodes[2 * cur]).w);
    const int link = __float_as_int(__ldg(&nodes[2 * cur + 1]).w);
    int next = -1;
    unsigned next_here = 0;
    if (meta > 0) {  // a leaf: tiles [link, link + meta), n real slots
      // each lane takes one of 32 triangles, and the rays of the lanes
      // that reach the leaf are tested against them in turn
      const int n = __ldg(&leaf_real[cur]);
      const int k0 = link * TC;
      unsigned todo_lanes = here;  // reach the leaf, no occluder yet
      for (int base = 0; todo_lanes && base < n; base += 32) {
        const bool has = base + lane < n;
        float c[9];
        if (has) load_tri(tris, npad, k0 + base + lane, c);
        const int cnt = min(32, n - base);
        for (unsigned todo = todo_lanes; todo; todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          Ray q;
          q.ox = __shfl_sync(FULL, r.ox, src);
          q.oy = __shfl_sync(FULL, r.oy, src);
          q.oz = __shfl_sync(FULL, r.oz, src);
          q.dx = __shfl_sync(FULL, r.dx, src);
          q.dy = __shfl_sync(FULL, r.dy, src);
          q.dz = __shfl_sync(FULL, r.dz, src);
          const float qt = BOUNDED ? __shfl_sync(FULL, tmax, src) : 0.f;
          const bool h = has && q.occludes<BOUNDED>(c[0], c[1], c[2], c[3],
                                                    c[4], c[5], c[6], c[7],
                                                    c[8], qt);
          const unsigned hit = __ballot_sync(FULL, h);
          ++st.wtests;
          if (lane == src) {
            st.tests += cnt;
            occluded = occluded || hit != 0;
          }
          if (hit) todo_lanes &= ~(1u << src);
        }
      }
      open = __ballot_sync(FULL, live && !occluded);
    } else {  // inner: children cur + 1 and link, split axis -meta - 1
      const int c0 = cur + 1, c1 = link;
      float tn0, tf0, tn1, tf1;
      r.slab(nodes, c0, tn0, tf0);
      r.slab(nodes, c1, tn1, tf1);
      const bool r0 = mine && tn0 <= tf0 && tf0 > 0.f &&
                      (!BOUNDED || tn0 < tmax);
      const bool r1 = mine && tn1 <= tf1 && tf1 > 0.f &&
                      (!BOUNDED || tn1 < tmax);
      const unsigned m0 = __ballot_sync(FULL, r0);
      const unsigned m1 = __ballot_sync(FULL, r1);
      const int axis = -meta - 1;
      const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
      // child 0 lies on the low side: near for a direction >= 0
      const unsigned low = __ballot_sync(FULL, mine && d >= 0.f);
      const bool near0 = 2 * __popc(low) >= __popc(here);
      const int near = near0 ? c0 : c1, far = near0 ? c1 : c0;
      const unsigned nm = near0 ? m0 : m1, fm = near0 ? m1 : m0;
      if (nm && fm) {  // push the far child with its lanes
        if (lane == (sp & 31)) {
          if (sp < 32) {
            sn0 = far;
            sm0 = fm;
          } else {
            sn1 = far;
            sm1 = fm;
          }
        }
        ++sp;
      }
      if (nm) {
        next = near;
        next_here = nm;
      } else if (fm) {
        next = far;
        next_here = fm;
      }
    }
    while (next < 0 && sp > 0 && open) {  // pop: only lanes still open
      --sp;
      const int src = sp & 31;
      const int node = __shfl_sync(FULL, sp < 32 ? sn0 : sn1, src);
      const unsigned m = __shfl_sync(FULL, sp < 32 ? sm0 : sm1, src) & open;
      if (m) {
        next = node;
        next_here = m;
      }
    }
    if (next < 0) break;
    cur = next;
    here = next_here;
  }
  return occluded;
}

// a warp's counters: the lane sums and the warp's own (lane 0's)
__device__ __forceinline__ void warp_stats(const WalkStats& st, int* out) {
  const int vis = __reduce_add_sync(FULL, st.visits);
  const int tests = __reduce_add_sync(FULL, st.tests);
  if ((threadIdx.x & 31) == 0) {
    out[0] = vis;
    out[1] = tests;
    out[2] = st.wvisits;
    out[3] = st.wtests;
  }
}

// Moller-Trumbore of ray r against the triangle c = (v0, e1, e2) in the
// twin's operation order (accel/isect._mt_tile): the key of a hit with 0 <
// t < t_lim, t's bits (t > 0, so the bits order as the values), else
// NO_HIT; u and v beside it.
constexpr unsigned NO_HIT = 0xffffffffu;

__device__ __forceinline__ unsigned mt_key(const Ray& r, const float (&c)[9],
                                           float t_lim, float& u, float& v) {
  const float px = r.dy * c[8] - r.dz * c[7];
  const float py = r.dz * c[6] - r.dx * c[8];
  const float pz = r.dx * c[7] - r.dy * c[6];
  const float a = c[3] * px + c[4] * py + c[5] * pz;
  const float sx = r.ox - c[0], sy = r.oy - c[1], sz = r.oz - c[2];
  const float qx = sy * c[5] - sz * c[4];
  const float qy = sz * c[3] - sx * c[5];
  const float qz = sx * c[4] - sy * c[3];
  const bool valid = fabsf(a) > DET_EPS;
  const float inva = valid ? 1.0f / a : 0.0f;
  u = (sx * px + sy * py + sz * pz) * inva;
  v = (qx * r.dx + qy * r.dy + qz * r.dz) * inva;
  const float t = (c[6] * qx + c[7] * qy + c[8] * qz) * inva;
  const bool hit = valid && u >= 0.f && u <= 1.f && v >= 0.f &&
                   u + v <= 1.f && t > 0.f && t < t_lim;
  return hit ? __float_as_uint(t) : NO_HIT;
}

// Kernel 4: a warp walks one ray (module comment).  The warp's stack
// lives in dynamic shared memory, `depth` int4 entries (node, entry t
// bits, meta, link), written by lane 0.
__global__ void __launch_bounds__(BLOCK)
bvh_closest_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                   const float* __restrict__ tmax_in,
                   const unsigned char* __restrict__ active, int B,
                   const float* __restrict__ tris, int npad,
                   const float4* __restrict__ nodes,
                   const int* __restrict__ leaf_real, int depth,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ tri_out,
                   int* __restrict__ stats) {
  extern __shared__ int4 stack_mem[];
  const int lane = threadIdx.x & 31;
  int4* const stack = stack_mem + (threadIdx.x >> 5) * depth;
  const int i = blockIdx.x * (BLOCK / 32) + (threadIdx.x >> 5);  // the ray
  const bool live = i < B && (active == nullptr || active[i] != 0);
  float t_best = i < B ? tmax_in[i] : 0.f;  // a miss reports its tmax
  float u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  int visits = 0, tests = 0, steps = 0;  // the same in every lane
  if (live) {
    Ray r;
    r.ox = org[3 * i + 0];
    r.oy = org[3 * i + 1];
    r.oz = org[3 * i + 2];
    r.set_dir(dir[3 * i + 0], dir[3 * i + 1], dir[3 * i + 2]);
    // the node entered next, with its meta and link words, which an inner
    // node's box loads already bring for its children
    int cur = 0;
    int meta = __float_as_int(__ldg(&nodes[0]).w);
    int link = __float_as_int(__ldg(&nodes[1]).w);
    int sp = 0;
    while (true) {
      // every lane has read the last popped entry before lane 0 may
      // overwrite it
      __syncwarp();
      ++visits;
      int next = -1, nmeta = 0, nlink = 0;
      if (meta > 0) {  // a leaf: tiles [link, link + meta), n real slots
        const int n = __ldg(&leaf_real[cur]);
        const int k0 = link * TC;
        tests += n;
        // chunks of 32 slots in slot order, lane l taking slot base + l,
        // each tested against t_best as the chunk starts; the least (t,
        // slot) of a chunk, the lowest slot on equal t, replaces t_best
        // only if nearer: the serial strict t < t_best loop's answer
        for (int base = 0; base < n; base += 32) {
          ++steps;
          unsigned key = NO_HIT;
          float u = 0.f, v = 0.f;
          if (base + lane < n) {
            float c[9];
            load_tri(tris, npad, k0 + base + lane, c);
            key = mt_key(r, c, t_best, u, v);
          }
          const unsigned least = __reduce_min_sync(FULL, key);
          if (least != NO_HIT) {
            const int src = __ffs(__ballot_sync(FULL, key == least)) - 1;
            t_best = __uint_as_float(least);
            u_best = __shfl_sync(FULL, u, src);
            v_best = __shfl_sync(FULL, v, src);
            tri_best = k0 + base + src;
          }
        }
      } else {  // inner: children cur + 1 and link, split axis -meta - 1
        const int c0 = cur + 1, c1 = link;
        const float4 lo0 = __ldg(&nodes[2 * c0]), hi0 = __ldg(&nodes[2 * c0 + 1]);
        const float4 lo1 = __ldg(&nodes[2 * c1]), hi1 = __ldg(&nodes[2 * c1 + 1]);
        float tn0, tf0, tn1, tf1;
        r.slab(lo0, hi0, tn0, tf0);
        r.slab(lo1, hi1, tn1, tf1);
        const bool r0 = tn0 <= tf0 && tf0 > 0.f && tn0 < t_best;
        const bool r1 = tn1 <= tf1 && tf1 > 0.f && tn1 < t_best;
        const int axis = -meta - 1;
        const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        const bool near0 = d >= 0.f;  // child 0 lies on the low side
        const bool reach_near = near0 ? r0 : r1;
        const bool reach_far = near0 ? r1 : r0;
        const int near = near0 ? c0 : c1, far = near0 ? c1 : c0;
        const int near_meta = __float_as_int(near0 ? lo0.w : lo1.w);
        const int near_link = __float_as_int(near0 ? hi0.w : hi1.w);
        const int far_meta = __float_as_int(near0 ? lo1.w : lo0.w);
        const int far_link = __float_as_int(near0 ? hi1.w : hi0.w);
        if (reach_near && reach_far) {  // push the far child, its entry
          if (lane == 0)
            stack[sp] = make_int4(far, __float_as_int(near0 ? tn1 : tn0),
                                  far_meta, far_link);
          ++sp;
        }
        if (reach_near) {
          next = near;
          nmeta = near_meta;
          nlink = near_link;
        } else if (reach_far) {
          next = far;
          nmeta = far_meta;
          nlink = far_link;
        }
      }
      // pop a pushed child only if its entry is still before t_best
      while (next < 0 && sp > 0) {
        const int4 e = stack[--sp];
        if (__int_as_float(e.y) < t_best) {
          next = e.x;
          nmeta = e.z;
          nlink = e.w;
        }
      }
      if (next < 0) break;
      cur = next;
      meta = nmeta;
      link = nlink;
    }
  }
  if (lane == 0 && i < B) {
    t_out[i] = t_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
    tri_out[i] = tri_best;
    int* out = stats + NSTAT * i;
    out[0] = visits;
    out[1] = tests;
    out[2] = visits;  // the walk's node visits are its ray's
    out[3] = steps;
  }
}

__global__ void __launch_bounds__(BLOCK)
bvh_any_kernel(const float* __restrict__ org, const float* __restrict__ dir,
               const float* __restrict__ tmax_in, int B,
               const float* __restrict__ tris, int npad,
               const float4* __restrict__ nodes,
               const int* __restrict__ leaf_real, bool* __restrict__ occ_out,
               int* __restrict__ stats) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int lane = threadIdx.x & 31;
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
  r.set_dir(r.dx, r.dy, r.dz);
  WalkStats st;
  const bool occ = warp_walk<true>(r, tmax, live, tris, npad, nodes,
                                   leaf_real, lane, st);
  if (live) occ_out[i] = occ;
  warp_stats(st, stats + NSTAT * (i >> 5));
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
              const float4* __restrict__ nodes,
              const int* __restrict__ leaf_real, const int* __restrict__ perm,
              int S, int K, int ntheta, float inv_nt, float inv_np,
              float* __restrict__ occ_out, int* __restrict__ stats) {
  __shared__ int counts[AO_THREADS];
  __shared__ int wst[AO_THREADS / 32][NSTAT];
  const int G = 32 / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane % G, k = lane / G;
  const int slot = blockIdx.x * G + g;
  const int n_live = min(nact[0], B);
  if (blockIdx.x * G >= n_live) {  // a block of dead slots: no work
    if (threadIdx.x < G && slot < B) occ_out[slot] = 0.f;
    if (threadIdx.x < NSTAT) stats[NSTAT * blockIdx.x + threadIdx.x] = 0;
    return;
  }
  const bool live = slot < n_live;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f};
  if (live) {
    r.ox = rays[slot];
    r.oy = rays[(size_t)B + slot];
    r.oz = rays[(size_t)2 * B + slot];
  }
  int occluded = 0;
  WalkStats st;
  for (int run = warp; run < S / K; run += nwarps) {
    if (live) {
      // the stratum's direction: accel/ao.stratum_directions' f32 chain;
      // the basis and jitter are read again each run (L1 hits), not held
      // in registers through the walk
      float b[9];
#pragma unroll
      for (int c = 0; c < 9; ++c)
        b[c] = __ldg(&rays[(size_t)(c + 3) * B + slot]);
      const float u0l = __ldg(&jit[slot]), u1l = __ldg(&jit[(size_t)B + slot]);
      const int s = perm[run * K + k];
      const float sf = (float)s;
      const float sh0 = sf * R2_A1;
      const float sh1 = sf * R2_A2;
      float u0 = u0l + (sh0 - floorf(sh0));
      u0 = u0 - floorf(u0);
      float u1 = u1l + (sh1 - floorf(sh1));
      u1 = u1 - floorf(u1);
      const float fi = (float)(s % ntheta);
      const float fj = (float)(s / ntheta);
      const float z0 = (fi + u0) * inv_nt;
      const float z1 = (fj + u1) * inv_np;
      const float cos_t = sqrtf(z0);
      const float phi = TWO_PI * z1;
      const float lx = cosf(phi) * cos_t;
      const float ly = sinf(phi) * cos_t;
      const float lz = sqrtf(fmaxf(1.0f - z0, 0.0f));
      r.set_dir(lx * b[0] + ly * b[3] + lz * b[6],
                lx * b[1] + ly * b[4] + lz * b[7],
                lx * b[2] + ly * b[5] + lz * b[8]);
    }
    occluded += warp_walk<false>(r, 0.f, live, tris, npad, nodes, leaf_real,
                                 lane, st);
  }
  counts[threadIdx.x] = occluded;
  warp_stats(st, wst[warp]);
  __syncthreads();
  if (threadIdx.x < G && slot < B) {  // a slot's strata, in a fixed order
    int total = 0;
    for (int w = 0; w < nwarps; ++w)
      for (int kk = 0; kk < K; ++kk) total += counts[w * 32 + kk * G + g];
    occ_out[slot] = (float)total;
  }
  if (threadIdx.x < NSTAT) {
    int sum = 0;
    for (int w = 0; w < nwarps; ++w) sum += wst[w][threadIdx.x];
    stats[NSTAT * blockIdx.x + threadIdx.x] = sum;
  }
}

}  // namespace

// active: B bytes (non-zero = live) or null (every ray live); depth: the
// tree's stack depth (at most STACK); stats: NSTAT ints a ray
extern "C" int lt_bvh_closest_hit(const float* org, const float* dir,
                                  const float* tmax,
                                  const unsigned char* active, int B,
                                  const float* tris, int npad,
                                  const void* nodes, const int* leaf_real,
                                  int depth, float* t, float* u, float* v,
                                  int* tri, int* stats, void* stream) {
  if (B <= 0) return 0;
  if (depth < 0 || depth > STACK)
    return static_cast<int>(cudaErrorInvalidValue);
  depth = depth > 0 ? depth : 1;
  constexpr int RAYS = BLOCK / 32;  // a warp a ray
  bvh_closest_kernel<<<(B + RAYS - 1) / RAYS, BLOCK,
                       RAYS * depth * sizeof(int4),
                       static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, active, B, tris, npad,
      static_cast<const float4*>(nodes), leaf_real, depth, t, u, v, tri,
      stats);
  return static_cast<int>(cudaGetLastError());
}

// stats: NSTAT ints a warp of 32 rays
extern "C" int lt_bvh_any_hit(const float* org, const float* dir,
                              const float* tmax, int B, const float* tris,
                              int npad, const void* nodes,
                              const int* leaf_real, bool* occ, int* stats,
                              void* stream) {
  if (B <= 0) return 0;
  bvh_any_kernel<<<grid_for(B), BLOCK, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmax, B, tris, npad, static_cast<const float4*>(nodes),
      leaf_real, occ, stats);
  return static_cast<int>(cudaGetLastError());
}

// K strata per warp (K divides 32 and S), warps per block (1-8, at most
// S / K); stats: NSTAT ints a block of G = 32 / K slots
extern "C" int lt_bvh_ao_fused(const float* rays, const float* jitter, int B,
                               const int* nact, const float* tris, int npad,
                               const void* nodes, const int* leaf_real,
                               const int* perm, int S, int K, int warps,
                               int ntheta, float inv_ntheta, float inv_nphi,
                               float* occ, int* stats, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || 32 % K || S % K || warps < 1 || warps * 32 > AO_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 32 / K;
  bvh_ao_kernel<<<(B + G - 1) / G, warps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      rays, jitter, B, nact, tris, npad, static_cast<const float4*>(nodes),
      leaf_real, perm, S, K, ntheta, inv_ntheta, inv_nphi, occ, stats);
  return static_cast<int>(cudaGetLastError());
}
