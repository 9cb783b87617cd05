// Dense closest hit and any-hit of a ray wavefront against a Morton-sorted
// triangle soup, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of lucille_tpu/accel/pallas_isect.py:
//   * _isect_kernel (:57), behind pallas_closest_hit: per ray the nearest
//     hit with 0 < t < tmax (an optional per-ray tmax, +inf unbounded:
//     the dirt map's gather, where lucille_tpu answers with its MXU path,
//     lucille_tpu/accel/mxu.py:112,151-152, t_best starting at tmax),
//     Moller-Trumbore with |det| > 1e-14, u, v >= 0, u + v <= 1; among
//     equal t the lowest triangle index wins; misses report t = +inf,
//     u = v = 0, tri = -1.  An optional `active` mask marks the live rays
//     of a bounce wavefront; a dead ray does no work and reports a miss.
//   * _anyhit_kernel (:390), behind pallas_any_hit: per ray whether any
//     triangle is hit with 0 < t < tmax (per-ray tmax, +inf unbounded),
//     by the same Moller-Trumbore test; an optional `active` mask marks the
//     live rays, and a dead ray does no work and reports "not occluded".
//
// What bounds them on the H100: f32 ALU work per needed ray-triangle pair
// (~56 operations and one IEEE divide; built with --fmad=false, so ~2x
// the f32 peak's bound is the floor).  The packed triangles of a dense
// scene (36 bytes each, <= 4.8 MB at 132k triangles) sit in L2.
//
// What the design does about it:
//   * one thread per ray, BLOCK rays a block, and every warp walks the
//     scene at its own pace: no block barrier and no shared memory;
//   * hierarchical, warp-uniform culls by the slab test, each bounded by
//     the lane's running t, which starts at its tmax (closest hit), or by
//     its tmax (any-hit), over the
//     open lanes (a lane that is dead or already occluded is not open):
//     the 16-tile supertile (scene.sboxes); then, in one unrolled batch
//     of independent loads, the supertile's 16 tiles (scene.boxes); then,
//     for each tile some lane reaches, in another batch its 16 groups of
//     8 triangles (scene.sub_boxes).  The warp visits the union of its
//     lanes' groups in index order, each with a ballot of the lanes that
//     reach it and are still open.  Every cull is conservative: a hit at
//     t lies in the boxes around its triangle, whose slab entry is <= t,
//     and a bound taken at a batch's start only admits more.  An empty
//     box (min > max: a tile or group of padding alone) is never reached;
//   * the loops stop at the scene's last real triangle (n_tris), so no
//     pad slot is ever tested;
//   * a group that many lanes reach is tested lane by lane, each lane its
//     own ray against the group's triangles, read with warp-uniform
//     16-byte loads (one load of each of the nine rows [v0 | e1 | e2]
//     brings four triangles); a group that at most SPARSE lanes reach is
//     tested with its triangles across the lanes, four rays a step
//     (struct Spread), the nearest hit of a ray reduced over its 8-lane
//     slot by shuffles, lowest index first at equal t;
//   * the any-hit leaves a group as soon as every lane that reached it is
//     occluded, and a walk once every lane is;
//   * when ceil(B / BLOCK) blocks cannot fill the card, the wrapper
//     (accel/isect.py:split_layout) splits the supertiles into `chunks`
//     ranges along gridDim.y.  The any-hit then ORs: its output is zeroed
//     first, an occluded lane stores 1, and a lane that another chunk has
//     already occluded stops at its next supertile.  The closest hit
//     (every chunk starting from the ray's tmax) merges with a 64-bit
//     atomicMin on (float bits of t << 32 | tri), a key left at its
//     memset value being a miss:
//     exact, because t > 0 orders like its bits and the lower index wins at
//     equal t, as it does inside a chunk; an epilogue recomputes the
//     winner's u, v by the same arithmetic;
//   * counters, NSTAT ints per (chunk, warp), written only when the
//     caller passes a buffer: the lanes' group visits (a lane visits a
//     group whose box it reaches), the lanes' triangle tests, the warp's
//     group visits and its triangle steps (a step tests one triangle for
//     every lane), so tests / (32 steps) is the walk's SIMT efficiency.
//
// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twins (accel/isect.py: closest_hit_reference,
// any_hit_reference).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int TC = 128;     // triangles per tile
constexpr int SUPER = 16;   // tiles per supertile
constexpr int SUB = 8;      // triangles per group box (accel/pack.py)
constexpr int BLOCK = 128;  // rays per block (accel/isect.py: BLOCK)
constexpr int NSTAT = 4;    // counters per (chunk, warp)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_HIT = ~0ull;
constexpr float DET_EPS = 1e-14f;
// a group that at most SPARSE lanes reach is tested with its triangles
// across the lanes (struct Spread)
constexpr int SPARSE = 8;

__device__ __forceinline__ float bounded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

__device__ __forceinline__ float comp(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
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

  // does the ray reach box k before t_lim?  Rows of `box` are [min xyz |
  // max xyz] over n columns; an empty box (min > max) is never reached.
  __device__ __forceinline__ bool reaches(const float* __restrict__ box, int n,
                                          int k, float t_lim) const {
    const float x0 = __ldg(box + 0 * n + k), x1 = __ldg(box + 3 * n + k);
    const float y0 = __ldg(box + 1 * n + k), y1 = __ldg(box + 4 * n + k);
    const float z0 = __ldg(box + 2 * n + k), z1 = __ldg(box + 5 * n + k);
    if (!(x0 <= x1 && y0 <= y1 && z0 <= z1)) return false;
    const float t0x = (x0 - ox) * invx, t1x = (x1 - ox) * invx;
    const float t0y = (y0 - oy) * invy, t1y = (y1 - oy) * invy;
    const float t0z = (z0 - oz) * invz, t1z = (z1 - oz) * invz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return tn <= tf && tf > 0.f && tn < t_lim;
  }

  // Moller-Trumbore against the triangle (v0, e1, e2): a hit with
  // 0 < t < t_lim, writing t, u, v.
  __device__ __forceinline__ bool hits(float v0x, float v0y, float v0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       float t_lim, float& t, float& u,
                                       float& v) const {
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

// Triangles c .. c + 3 (c % 4 == 0) of the pack: one 16-byte load of each
// of the nine rows [v0 | e1 | e2], the same address in every lane.
struct Quad {
  float4 r[9];

  __device__ __forceinline__ void load(const float* __restrict__ tris,
                                       int npad, int c) {
#pragma unroll
    for (int row = 0; row < 9; ++row) {
      r[row] = __ldg(reinterpret_cast<const float4*>(
          tris + (size_t)row * npad + c));
    }
  }

  __device__ __forceinline__ bool hits(const Ray& ray, int q, float t_lim,
                                       float& t, float& u, float& v) const {
    return ray.hits(comp(r[0], q), comp(r[1], q), comp(r[2], q),
                    comp(r[3], q), comp(r[4], q), comp(r[5], q),
                    comp(r[6], q), comp(r[7], q), comp(r[8], q), t_lim, t, u,
                    v);
  }
};

// A sparse group's triangles across the warp: lane l holds triangle
// c0 + l % 8 and tests it against the ray of slot l / 8, four reaching
// rays a step, each ray's lane handing its ray over by shuffles.
struct Spread {
  float tv[9];  // v0, e1, e2 of the lane's triangle
  int c;        // its index
  bool real;    // c < c1

  __device__ __forceinline__ void load(const float* __restrict__ tris,
                                       int npad, int c0, int c1) {
    c = c0 + (threadIdx.x & 7);
    real = c < c1;
#pragma unroll
    for (int row = 0; row < 9; ++row) {
      tv[row] = real ? __ldg(tris + (size_t)row * npad + c) : 0.f;
    }
  }

  // the next four (or fewer) lanes of m, as a mask; src: the lane of this
  // lane's slot, -1 if the batch has no ray for it
  static __device__ __forceinline__ unsigned batch(unsigned m, int& src) {
    const int slot = (threadIdx.x & 31) >> 3;
    unsigned b = 0u;
    src = -1;
    for (int q = 0; q < 4 && m != 0u; ++q) {
      const int l = __ffs(m) - 1;
      if (q == slot) src = l;
      b |= 1u << l;
      m &= m - 1u;
    }
    return b;
  }

  // the ray of lane src (lane 0's if src < 0)
  static __device__ __forceinline__ Ray fetch(const Ray& ray, int src) {
    const int l = src < 0 ? 0 : src;
    Ray r;
    r.ox = __shfl_sync(FULL, ray.ox, l);
    r.oy = __shfl_sync(FULL, ray.oy, l);
    r.oz = __shfl_sync(FULL, ray.oz, l);
    r.dx = __shfl_sync(FULL, ray.dx, l);
    r.dy = __shfl_sync(FULL, ray.dy, l);
    r.dz = __shfl_sync(FULL, ray.dz, l);
    return r;
  }

  __device__ __forceinline__ bool hits(const Ray& r, int src, float t_lim,
                                       float& t, float& u, float& v) const {
    return r.hits(tv[0], tv[1], tv[2], tv[3], tv[4], tv[5], tv[6], tv[7],
                  tv[8], t_lim, t, u, v) &&
           real && src >= 0;
  }
};

struct Stats {
  int visits = 0, tests = 0, wvisits = 0, wtests = 0;

  // the lane sums and the warp's own (lane 0's) counts into out[0:4]
  __device__ __forceinline__ void store(int* out) const {
    const int vis = __reduce_add_sync(FULL, visits);
    const int tst = __reduce_add_sync(FULL, tests);
    if ((threadIdx.x & 31) == 0) {
      out[0] = vis;
      out[1] = tst;
      out[2] = wvisits;
      out[3] = wtests;
    }
  }
};

struct Scene {
  const float* tris;  // (16, npad) [v0 | e1 | e2 | 0]
  int npad, n_tris;
  const float* boxes;  // (8, n_tiles)
  int n_tiles;
  const float* sboxes;  // (8, n_super)
  int n_super;
  const float* sub;  // (8, npad / SUB)

  // the supertiles that hold a real triangle
  __device__ __forceinline__ int real_super() const {
    return ((n_tris + TC - 1) / TC + SUPER - 1) / SUPER;
  }
};

// The warp's walk of supertile sk: open() says whether a lane takes part,
// bound() the t before which its boxes must be reached.  Every group of
// real triangles [c0, c1) that some open lane reaches goes, in index
// order, to test(c0, c1, lanes reaching it).  Each lane tests the 16
// tiles of the supertile, and then the 16 groups of a tile, in one
// unrolled batch of independent loads (against its bound at the batch's
// start, a superset of what it reaches later); the warp then visits the
// union.  Warp-uniform control flow throughout.
template <class Open, class Bound, class Test>
__device__ __forceinline__ void walk_super(const Scene& sc, const Ray& ray,
                                           int sk, Open open, Bound bound,
                                           Test test) {
  const bool in_s = open() && ray.reaches(sc.sboxes, sc.n_super, sk, bound());
  if (!__any_sync(FULL, in_s)) return;
  const int k0 = sk * SUPER;
  const int nk = min(SUPER, (sc.n_tris + TC - 1) / TC - k0);
  unsigned tiles = 0u;  // bit q: this lane reaches tile k0 + q
  if (in_s) {
#pragma unroll
    for (int q = 0; q < SUPER; ++q) {
      if (q < nk && ray.reaches(sc.boxes, sc.n_tiles, k0 + q, bound())) {
        tiles |= 1u << q;
      }
    }
  }
  const int n_groups = sc.n_tiles * (TC / SUB);
  for (unsigned wt = __reduce_or_sync(FULL, tiles); wt != 0u; wt &= wt - 1u) {
    const int k = k0 + __ffs(wt) - 1;
    const bool in_t = ((tiles >> (k - k0)) & 1u) && open();
    if (!__any_sync(FULL, in_t)) continue;
    const int c_end = min((k + 1) * TC, sc.n_tris);
    const int ng = (c_end - k * TC + SUB - 1) / SUB;
    unsigned groups = 0u;  // bit g: this lane reaches group g of tile k
    if (in_t) {
#pragma unroll
      for (int g = 0; g < TC / SUB; ++g) {
        if (g < ng &&
            ray.reaches(sc.sub, n_groups, k * (TC / SUB) + g, bound())) {
          groups |= 1u << g;
        }
      }
    }
    for (unsigned wg = __reduce_or_sync(FULL, groups); wg != 0u;
         wg &= wg - 1u) {
      const int g = __ffs(wg) - 1;
      const unsigned rg =
          __ballot_sync(FULL, ((groups >> g) & 1u) && open());
      const int c0 = k * TC + g * SUB;
      if (rg != 0u) test(c0, min(c0 + SUB, c_end), rg);
    }
  }
}

// gridDim.y chunks of per_chunk supertiles; kSplit: more than one chunk,
// the answers merged in key_out (the epilogue writes t, u, v, tri)
// (at most 4 blocks an SM: left alone, ptxas stops at 96 registers and
// spills)
template <bool kSplit>
__global__ void __launch_bounds__(BLOCK, 4)
closest_hit_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                   const float* __restrict__ tmax,
                   const unsigned char* __restrict__ active, int B, Scene sc,
                   int per_chunk, float* __restrict__ t_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ tri_out,
                   unsigned long long* __restrict__ key_out,
                   int* __restrict__ stats) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B && (active == nullptr || active[i] != 0);
  const unsigned me = 1u << (threadIdx.x & 31);
  Ray ray;
  ray.load(org, dir, i, live);

  // a hit needs t < tmax: the walk's culls prune against it from the start
  float t_best = live && tmax != nullptr ? tmax[i] : INFINITY;
  float u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  Stats st;
  const int s0 = blockIdx.y * per_chunk;
  const int s1 = min(s0 + per_chunk, sc.real_super());
  if (__any_sync(FULL, live)) {
    for (int sk = s0; sk < s1; ++sk) {
      walk_super(
          sc, ray, sk, [&] { return live; }, [&] { return t_best; },
          [&](int c0, int c1, unsigned rg) {
            const bool mine = rg & me;
            ++st.wvisits;
            if (mine) {
              ++st.visits;
              st.tests += c1 - c0;
            }
            if (__popc(rg) <= SPARSE) {
              Spread sp;
              sp.load(sc.tris, sc.npad, c0, c1);
              for (unsigned m = rg; m != 0u;) {
                int src;
                const unsigned b = Spread::batch(m, src);
                m &= ~b;
                ++st.wtests;
                const int sl = src < 0 ? 0 : src;
                float t, u, v;
                const bool h = sp.hits(Spread::fetch(ray, src), src,
                                       __shfl_sync(FULL, t_best, sl), t, u,
                                       v);
                // the slot's nearest hit, the lowest index at equal t
                float bt = h ? t : INFINITY;
                int bc = h ? sp.c : INT_MAX;
#pragma unroll
                for (int off = 4; off > 0; off >>= 1) {
                  const float ot = __shfl_xor_sync(FULL, bt, off);
                  const int oc = __shfl_xor_sync(FULL, bc, off);
                  if (ot < bt || (ot == bt && oc < bc)) {
                    bt = ot;
                    bc = oc;
                  }
                }
                // the ray's lane reads its slot's answer, u and v from the
                // lane that holds the winning triangle
                const int slot = 8 * __popc(b & (me - 1u));
                bt = __shfl_sync(FULL, bt, slot & 31);
                bc = __shfl_sync(FULL, bc, slot & 31);
                const int win = static_cast<int>(
                    (static_cast<unsigned>(slot) + static_cast<unsigned>(bc) -
                     static_cast<unsigned>(c0)) & 31u);
                u = __shfl_sync(FULL, u, win);
                v = __shfl_sync(FULL, v, win);
                if ((b & me) && bc != INT_MAX) {
                  t_best = bt;
                  u_best = u;
                  v_best = v;
                  tri_best = bc;
                }
              }
              return;
            }
            st.wtests += c1 - c0;
            for (int c = c0; c < c1; c += 4) {
              Quad quad;
              quad.load(sc.tris, sc.npad, c);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                float t, u, v;
                // strict t < t_best in index order: the lowest index wins
                if (c + q < c1 && quad.hits(ray, q, t_best, t, u, v) &&
                    mine) {
                  t_best = t;
                  u_best = u;
                  v_best = v;
                  tri_best = c + q;
                }
              }
            }
          });
    }
  }

  if constexpr (kSplit) {
    if (tri_best >= 0) {
      atomicMin(&key_out[i],
                (static_cast<unsigned long long>(__float_as_uint(t_best))
                 << 32) | static_cast<unsigned>(tri_best));
    }
  } else if (i < B) {
    t_out[i] = tri_best >= 0 ? t_best : INFINITY;
    u_out[i] = u_best;
    v_out[i] = v_best;
    tri_out[i] = tri_best;
  }
  if (stats != nullptr) {
    st.store(stats + NSTAT * ((size_t)blockIdx.y * gridDim.x * (BLOCK / 32) +
                              (i >> 5)));
  }
}

// the split closest hit's answers from its merged keys: t from the key,
// u and v of the winning triangle by the kernel's own arithmetic
__global__ void __launch_bounds__(256)
closest_epilogue(const float* __restrict__ org, const float* __restrict__ dir,
                 int B, const float* __restrict__ tris, int npad,
                 const unsigned long long* __restrict__ key,
                 float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const unsigned long long k = key[i];
  if (k == NO_HIT) {
    t_out[i] = INFINITY;
    u_out[i] = 0.f;
    v_out[i] = 0.f;
    tri_out[i] = -1;
    return;
  }
  const int c = static_cast<int>(k & 0xffffffffull);
  Ray ray;
  ray.load(org, dir, i, true);
  float t, u, v;
  const float* p = tris + c;
  ray.hits(p[0], p[npad], p[2 * (size_t)npad], p[3 * (size_t)npad],
           p[4 * (size_t)npad], p[5 * (size_t)npad], p[6 * (size_t)npad],
           p[7 * (size_t)npad], p[8 * (size_t)npad], INFINITY, t, u, v);
  t_out[i] = __uint_as_float(static_cast<unsigned>(k >> 32));
  u_out[i] = u;
  v_out[i] = v;
  tri_out[i] = c;
}

// kSplit: more than one chunk; occ_out was zeroed and only 1s are stored
template <bool kSplit>
__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ org, const float* __restrict__ dir,
               const float* __restrict__ tmax,
               const unsigned char* __restrict__ active, int B, Scene sc,
               int per_chunk, unsigned char* occ_out,
               int* __restrict__ stats) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < B && (active == nullptr || active[i] != 0);
  const unsigned me = 1u << (threadIdx.x & 31);
  Ray ray;
  ray.load(org, dir, i, live);
  const float t_lim = live ? tmax[i] : 0.f;
  // other chunks' answers (split only)
  const volatile unsigned char* seen = occ_out;

  bool occ = false;
  Stats st;
  const int s0 = blockIdx.y * per_chunk;
  const int s1 = min(s0 + per_chunk, sc.real_super());
  for (int sk = s0; sk < s1; ++sk) {
    if (kSplit && live && !occ && seen[i] != 0) occ = true;
    if (!__any_sync(FULL, live && !occ)) break;
    walk_super(
        sc, ray, sk, [&] { return live && !occ; }, [&] { return t_lim; },
        [&](int c0, int c1, unsigned rg) {
          ++st.wvisits;
          if (rg & me) ++st.visits;
          if (__popc(rg) <= SPARSE) {
            if (rg & me) st.tests += c1 - c0;
            Spread sp;
            sp.load(sc.tris, sc.npad, c0, c1);
            for (unsigned m = rg; m != 0u;) {
              int src;
              const unsigned b = Spread::batch(m, src);
              m &= ~b;
              ++st.wtests;
              float t, u, v;
              const unsigned hb = __ballot_sync(FULL, sp.hits(
                  Spread::fetch(ray, src), src,
                  __shfl_sync(FULL, t_lim, src < 0 ? 0 : src), t, u, v));
              if ((b & me) && ((hb >> (8 * __popc(b & (me - 1u)))) & 0xffu)) {
                occ = true;
                if (kSplit) occ_out[i] = 1;
              }
            }
            return;
          }
          unsigned open = rg;  // lanes that reached the group, not yet hit
          for (int c = c0; c < c1 && open != 0u; c += 4) {
            Quad quad;
            quad.load(sc.tris, sc.npad, c);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (c + q < c1 && open != 0u) {
                ++st.wtests;
                float t, u, v;
                const bool hit = quad.hits(ray, q, t_lim, t, u, v);
                if (open & me) {
                  ++st.tests;
                  if (hit) {
                    occ = true;
                    if (kSplit) occ_out[i] = 1;
                  }
                }
                open &= ~__ballot_sync(FULL, occ);
              }
            }
          }
        });
  }
  if (!kSplit && i < B) occ_out[i] = occ ? 1 : 0;
  if (stats != nullptr) {
    st.store(stats + NSTAT * ((size_t)blockIdx.y * gridDim.x * (BLOCK / 32) +
                              (i >> 5)));
  }
}

// the pack's shapes as accel/isect.py checks them, and a split that
// covers every real supertile
bool bad_layout(int B, const Scene& sc, int chunks, int per_chunk) {
  const int n_real = (sc.n_tris + TC - 1) / TC;
  return B < 0 || sc.n_tris < 0 || sc.n_tris > sc.npad ||
         sc.npad != sc.n_tiles * TC ||
         sc.n_super != (sc.n_tiles + SUPER - 1) / SUPER || chunks < 1 ||
         per_chunk < 1 || (long long)chunks * per_chunk * SUPER < n_real;
}

}  // namespace

// tmax: B floats, or null (every ray unbounded); active: B bytes (non-zero
// = live) or null (every ray live); n_tris: the
// real triangles, the first columns of tris; sboxes, sub: the supertile
// and 8-triangle group boxes; chunks x per_chunk: the split of the
// supertiles (accel/isect.py:split_layout); keys: B 64-bit words of
// scratch when chunks > 1; stats: NSTAT ints per (chunk, warp), or null
// (no counters)
extern "C" int lt_closest_hit(const float* org, const float* dir,
                              const float* tmax, const unsigned char* active,
                              int B,
                              const float* tris, int npad, int n_tris,
                              const float* boxes, int n_tiles,
                              const float* sboxes, int n_super,
                              const float* sub, int chunks, int per_chunk,
                              float* t, float* u, float* v, int* tri,
                              unsigned long long* keys, int* stats,
                              void* stream) {
  const Scene sc{tris, npad, n_tris, boxes, n_tiles, sboxes, n_super, sub};
  if (bad_layout(B, sc, chunks, per_chunk) || (chunks > 1 && !keys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BLOCK - 1) / BLOCK, chunks);
  if (chunks == 1) {
    closest_hit_kernel<false><<<grid, BLOCK, 0, s>>>(
        org, dir, tmax, active, B, sc, per_chunk, t, u, v, tri, keys, stats);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(*keys) * B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  closest_hit_kernel<true><<<grid, BLOCK, 0, s>>>(
      org, dir, tmax, active, B, sc, per_chunk, t, u, v, tri, keys, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  closest_epilogue<<<(B + 255) / 256, 256, 0, s>>>(org, dir, B, tris, npad,
                                                   keys, t, u, v, tri);
  return static_cast<int>(cudaGetLastError());
}

// operands as lt_closest_hit; tmax: B floats (not null)
extern "C" int lt_any_hit(const float* org, const float* dir,
                          const float* tmax, const unsigned char* active,
                          int B, const float* tris, int npad, int n_tris,
                          const float* boxes, int n_tiles, const float* sboxes,
                          int n_super, const float* sub, int chunks,
                          int per_chunk, unsigned char* occ, int* stats,
                          void* stream) {
  const Scene sc{tris, npad, n_tris, boxes, n_tiles, sboxes, n_super, sub};
  if (bad_layout(B, sc, chunks, per_chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BLOCK - 1) / BLOCK, chunks);
  if (chunks == 1) {
    any_hit_kernel<false><<<grid, BLOCK, 0, s>>>(org, dir, tmax, active, B,
                                                 sc, per_chunk, occ, stats);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaMemsetAsync(occ, 0, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  any_hit_kernel<true><<<grid, BLOCK, 0, s>>>(org, dir, tmax, active, B, sc,
                                              per_chunk, occ, stats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
