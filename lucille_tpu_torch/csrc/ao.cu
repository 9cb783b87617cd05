// Fused ambient-occlusion gather, hand-written for Hopper (sm_90a).
//
// Replaces: lucille_tpu/accel/pallas_ao.py:_ao_kernel (:109), the Pallas
// TPU kernel behind pallas_ao_occlusion (want_bits=False) and
// pallas_ao_occlusion_bits (want_bits=True).  Same contract: for each
// compacted hit lane j < nact, the number of its S = ntheta * nphi
// stratified cosine directions that hit a triangle; 0 for lanes at or past
// nact.  With the bits output (template flag kWantBits) also which of them:
// ceil(S / 32) int32 rows in compacted lane order, bit s % 32 of row s / 32
// set when stratum s is occluded, every row 0 for lanes at or past nact.
// Stratum s of lane j uses the lane's two uniforms (u0, u1) = jitter[:, j],
// shifted by the R2 Cranley-Patterson offsets frac(s * a1), frac(s * a2);
// cos_t = sqrt((i + u0) / ntheta), phi = 2 pi (j' + u1) / nphi,
// lz = sqrt(max(1 - z0, 0)), rotated into the lane's basis (b0, b1, b2).
// The hit test is the signed-volume form: U, V triple products,
// W = dn - U - V, a hit needs U, V, W of one sign, s_n * dn > 0 and
// |dn| > 1e-14.  All-zero pad triangles never occlude.  The file's second
// kernel, sky_gather_kernel (below), weights the bits by the sunsky sky.
//
// What bounds it on the H100: issued instructions.  Per stratum the data
// needs its (stratum, triangle) tests up to its first occluder (~30 f32
// operations each) and a slab test (~25) against each box of a tile it
// reaches (chip_smoke.gather_need); built with --fmad=false every product
// and sum issues alone, so ~2x the f32 peak's bound is the floor.  On the
// main path's shapes a stratum takes about as many group box tests as
// triangle tests, so a division in the slab test costs as much as the
// test itself; on a terrain of 127 tiles, testing every tile box for every
// pending stratum takes 13x the tile box tests the data needs.
//
// What the design does about it:
//   * a thread per (lane, chunk of C strata), C and the lane's T threads
//     from accel/ao.py:gather_layout: a block holds AO_BLOCK / T lanes,
//     thread tid serves lane tid % (AO_BLOCK / T) with chunks t, t + T,
//     ..., t = tid / (AO_BLOCK / T), so a warp holds one chunk of
//     neighbouring lanes (Morton-ordered from 8 tiles), whose directions
//     and occluders are alike; the lane's counts are summed and each bits
//     row is ORed from its chunks through shared memory and stored by one
//     thread (C divides 32: a chunk never straddles two rows), so every
//     output is written exactly once, without atomics;
//   * a thread's directions and their reciprocals live in shared memory
//     (dynamic, C x 6 floats a thread), indexed by stratum: a slab test
//     takes no division;
//   * one walk a warp, in slot order, with warp-uniform control flow and
//     no block barrier: each supertile, each tile of a supertile, each
//     quarter of a tile (32 triangles, its box the union of its four
//     group boxes) and each 8-triangle group of a quarter is entered when
//     some lane has a stratum that reaches its box (votes), skipped by
//     the whole warp otherwise.  Culls, all conservative: per lane a
//     tangent-plane test against the supertile and the tile box
//     (hemisphere directions satisfy d . n >= 0, so a box wholly below
//     the lane's tangent plane cannot occlude it), then per stratum a
//     slab test against the supertile, the tile, the quarter and the
//     group box (the slab test's roundings are monotone, so a ray that
//     reaches a box reaches every box around it: the quarter cull drops
//     no group a stratum reaches).  Every loop runs over the set bits of
//     a mask (__ffs), so an occluded stratum stops costing at its
//     occluder;
//   * the triangles are read where the warp's walk is, four at a time,
//     with warp-uniform 16-byte loads through L1 (a dense scene's pack is
//     at most 8 MB, in the 50 MB L2); a thread sets the four up against
//     its lane (vertex offsets, two cross products, s_n) and then takes
//     each of its strata that reach the group through the four in slot
//     order, a direction read once for four tests; the hit test combines
//     its conditions without short circuits (no branch);
//   * the walk stops at the scene's last real triangle (n_tris): no pad
//     slot is ever tested;
//   * counters, NSTAT ints a warp, only when the caller passes a buffer,
//     in instantiations of their own (kCount; the others count nothing):
//     supertile, tile, quarter and group box tests (a stratum against a
//     box), triangle set-ups, (triangle, stratum) tests and the warp's
//     test steps (over each four triangles, the most strata one of its
//     threads takes through them, times the triangles), so tests / (32
//     steps) is the walk's SIMT efficiency.  The walk keeps slot order, so
//     its tests equal gather_need's; its group box tests are those of
//     gather_need in a quarter the stratum reaches.

// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twin (accel/ao.py: ao_occlusion_reference).

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int TC = 128;        // triangles per tile
constexpr int SUPER = 16;      // tiles per supertile
constexpr int SUB = 8;         // triangles per group box (accel/pack.py)
constexpr int QUARTER = 4;     // groups per quarter of a tile
constexpr int AO_BLOCK = 128;  // threads per block (accel/ao.py: AO_BLOCK)
constexpr int NSTAT = 7;       // counters per warp (accel/ao.py: NSTAT)
constexpr unsigned FULL = 0xffffffffu;
constexpr float DET_EPS = 1e-14f;
constexpr float R2_A1 = 0.7548776662466927f;
constexpr float R2_A2 = 0.5698402909980532f;
constexpr float TWO_PI = 6.283185307179586f;

// A thread's strata in shared memory, one column a thread: at(q, 0..2)
// the direction of its stratum q, at(q, 3..5) the reciprocals its slab
// tests take.
struct Strata {
  float* col;  // smem + threadIdx.x

  __device__ __forceinline__ float& at(int q, int c) const {
    return col[(q * 6 + c) * AO_BLOCK];
  }
};

__device__ __forceinline__ float bounded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

__device__ __forceinline__ float comp(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// Stratum s's direction for a lane with uniforms (u0l, u1l) and the
// basis b0 = r[3..5], b1 = r[6..8], b2 = r[9..11] (the rays pack's rows):
// the header's formula, every operation rounded in f32 as
// accel/ao.py:stratum_directions rounds it.  ao_kernel tests this
// direction and sky_gather_kernel weights the sky along it, so the sky is
// read along the very direction whose occlusion bit kernel 3b computed.
__device__ __forceinline__ float3 stratum_dir(int s, float u0l, float u1l,
                                              int ntheta, float inv_nt,
                                              float inv_np,
                                              const float (&r)[12]) {
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
  return make_float3(lx * r[3] + ly * r[6] + lz * r[9],
                     lx * r[4] + ly * r[7] + lz * r[10],
                     lx * r[5] + ly * r[8] + lz * r[11]);
}

struct Stats {
  int supers = 0, tiles = 0, quarters = 0, groups = 0, setups = 0, tests = 0,
      steps = 0;

  // the warp's sums into out[0:NSTAT]
  __device__ __forceinline__ void store(int* out) const {
    const int v[NSTAT] = {
        __reduce_add_sync(FULL, supers), __reduce_add_sync(FULL, tiles),
        __reduce_add_sync(FULL, quarters), __reduce_add_sync(FULL, groups),
        __reduce_add_sync(FULL, setups), __reduce_add_sync(FULL, tests),
        steps};
    if ((threadIdx.x & 31) == 0) {
      for (int c = 0; c < NSTAT; ++c) out[c] = v[c];
    }
  }
};

// A lane's shading point and normal.
struct Lane {
  float ox, oy, oz, nx, ny, nz;

  // Is the corner of box k that is farthest along n below the plane
  // through o with normal n (the whole box below it)?  Rows of `box` are
  // [min xyz | max xyz].
  __device__ __forceinline__ bool below(const float* __restrict__ box,
                                        int n, int k) const {
    const float cx = __ldg(box + (nx > 0.f ? 3 : 0) * n + k);
    const float cy = __ldg(box + (ny > 0.f ? 4 : 1) * n + k);
    const float cz = __ldg(box + (nz > 0.f ? 5 : 2) * n + k);
    return !((cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz >= 0.f);
  }

  // The strata of `mask` whose rays reach box k (rows [min xyz | max
  // xyz], n columns); `count` grows by the strata tested.
  __device__ __forceinline__ unsigned reach(const float* __restrict__ box,
                                            int n, int k, unsigned mask,
                                            Strata v, int& count) const {
    if (mask == 0u) return 0u;
    float b[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) b[r] = __ldg(box + r * n + k);
    return reach(b, mask, v, count);
  }

  // The strata of `mask` whose rays reach the box b [min xyz | max xyz]: a
  // slab test of each; `count` grows by the strata tested.
  __device__ __forceinline__ unsigned reach(const float (&b)[6],
                                            unsigned mask, Strata v,
                                            int& count) const {
    if (mask == 0u) return 0u;
    count += __popc(mask);
    const float bminx = b[0], bminy = b[1], bminz = b[2];
    const float bmaxx = b[3], bmaxy = b[4], bmaxz = b[5];
    unsigned hit = 0u;
    for (unsigned m = mask; m != 0u; m &= m - 1u) {
      const int q = __ffs(m) - 1;
      const float ix = v.at(q, 3);
      const float iy = v.at(q, 4);
      const float iz = v.at(q, 5);
      const float t0x = (bminx - ox) * ix, t1x = (bmaxx - ox) * ix;
      const float t0y = (bminy - oy) * iy, t1y = (bmaxy - oy) * iy;
      const float t0z = (bminz - oz) * iz, t1z = (bmaxz - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
      if (tn <= tf && tf > 0.f) hit |= 1u << q;
    }
    return hit;
  }
};

// Triangles c .. c + 3 (c % 4 == 0) of the occlusion pack: one 16-byte
// load of each of its twelve rows [v0 | v1 | v2 | n], the same address in
// every lane.
struct Quad {
  float4 r[12];

  __device__ __forceinline__ void load(const float* __restrict__ tris,
                                       int npad, int c) {
#pragma unroll
    for (int row = 0; row < 12; ++row) {
      r[row] = __ldg(reinterpret_cast<const float4*>(
          tris + (size_t)row * npad + c));
    }
  }
};

// The origin-only terms of a triangle against a lane: the cross products
// of its vertex offsets, its normal and s_n.
struct Setup {
  float cbcx, cbcy, cbcz, ccax, ccay, ccaz, nx, ny, nz, s_n;

  __device__ __forceinline__ void make(const Quad& quad, int q,
                                       const Lane& L) {
    const float pax = comp(quad.r[0], q) - L.ox;
    const float pay = comp(quad.r[1], q) - L.oy;
    const float paz = comp(quad.r[2], q) - L.oz;
    const float pbx = comp(quad.r[3], q) - L.ox;
    const float pby = comp(quad.r[4], q) - L.oy;
    const float pbz = comp(quad.r[5], q) - L.oz;
    const float pcx = comp(quad.r[6], q) - L.ox;
    const float pcy = comp(quad.r[7], q) - L.oy;
    const float pcz = comp(quad.r[8], q) - L.oz;
    nx = comp(quad.r[9], q);
    ny = comp(quad.r[10], q);
    nz = comp(quad.r[11], q);
    cbcx = pby * pcz - pbz * pcy;
    cbcy = pbz * pcx - pbx * pcz;
    cbcz = pbx * pcy - pby * pcx;
    ccax = pcy * paz - pcz * pay;
    ccay = pcz * pax - pcx * paz;
    ccaz = pcx * pay - pcy * pax;
    s_n = pax * nx + pay * ny + paz * nz;
  }

  // does the ray along w from the lane's point hit the triangle?  (The
  // conditions combine without short circuits: one predicate chain, no
  // branch.)
  __device__ __forceinline__ bool hit(float wx, float wy, float wz) const {
    const float U = wx * cbcx + wy * cbcy + wz * cbcz;
    const float V = wx * ccax + wy * ccay + wz * ccaz;
    const float dn = wx * nx + wy * ny + wz * nz;
    const float W = dn - U - V;
    const bool inside = (fminf(fminf(U, V), W) >= 0.f) |
                        (fmaxf(fmaxf(U, V), W) <= 0.f);
    return inside & (s_n * dn > 0.f) & (fabsf(dn) > DET_EPS);
  }
};

// The quad's first nq triangles (nq warp-uniform) against the strata of
// `sr` (which reach their group): the four set-ups first, then each
// stratum against them in slot order up to its first occluder, which
// takes the stratum out of sr and pending; `tests` grows by the pairs
// tested.
__device__ __forceinline__ void test_quad(const Quad& quad, int nq,
                                          const Lane& L, Strata v,
                                          unsigned& sr, unsigned& pending,
                                          int& tests) {
  Setup tri[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < nq) tri[q].make(quad, q, L);
  }
  for (unsigned m = sr; m != 0u; m &= m - 1u) {
    const int s = __ffs(m) - 1;
    const float wx = v.at(s, 0);
    const float wy = v.at(s, 1);
    const float wz = v.at(s, 2);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < nq) {
        ++tests;
        if (tri[q].hit(wx, wy, wz)) {
          sr &= ~(1u << s);
          pending &= ~(1u << s);
          break;
        }
      }
    }
  }
}

struct Scene {
  const float* tris;  // (16, npad) [v0 | v1 | v2 | n | 0]
  int npad, n_tris;
  const float* boxes;  // (8, n_tiles)
  int n_tiles;
  const float* sboxes;  // (8, n_super)
  int n_super;
  const float* sub;  // (8, npad / SUB)
};

// The warp's walk of the scene for the strata of `pending` (bit q: the
// thread's stratum q, not yet occluded): every real triangle some lane's
// pending stratum reaches through its supertile, tile, quarter and group
// boxes is tested, in slot order.  Warp-uniform control flow; counting: the warp's
// test steps are counted (a reduction a triangle).
__device__ __forceinline__ void walk(const Scene& sc, const Lane& L, Strata v,
                                     unsigned& pending, Stats& st,
                                     bool counting) {
  const int n_real = (sc.n_tris + TC - 1) / TC;
  const int n_groups = sc.n_tiles * (TC / SUB);
  for (int sk = 0; sk * SUPER < n_real; ++sk) {
    if (!__any_sync(FULL, pending != 0u)) return;
    const unsigned in_s =
        pending != 0u && !L.below(sc.sboxes, sc.n_super, sk)
            ? L.reach(sc.sboxes, sc.n_super, sk, pending, v, st.supers)
            : 0u;
    if (!__any_sync(FULL, in_s != 0u)) continue;
    const int k1 = min(n_real, (sk + 1) * SUPER);
    for (int k = sk * SUPER; k < k1; ++k) {
      unsigned in_t = in_s & pending;
      in_t = in_t != 0u && !L.below(sc.boxes, sc.n_tiles, k)
                 ? L.reach(sc.boxes, sc.n_tiles, k, in_t, v, st.tiles)
                 : 0u;
      if (!__any_sync(FULL, in_t != 0u)) continue;
      const int c_end = min((k + 1) * TC, sc.n_tris);
      for (int q0 = k * TC; q0 < c_end; q0 += QUARTER * SUB) {
        in_t &= pending;
        if (!__any_sync(FULL, in_t != 0u)) break;
        // the quarter's box: the union of its groups' boxes (a group of
        // padding alone has an empty box, +inf / -inf, and adds nothing)
        float qb[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(
              sc.sub + r * n_groups + q0 / SUB));
          qb[r] = r < 3 ? fminf(fminf(g.x, g.y), fminf(g.z, g.w))
                        : fmaxf(fmaxf(g.x, g.y), fmaxf(g.z, g.w));
        }
        unsigned in_q = L.reach(qb, in_t, v, st.quarters);
        if (!__any_sync(FULL, in_q != 0u)) continue;
        const int q_end = min(q0 + QUARTER * SUB, c_end);
        for (int c0 = q0; c0 < q_end; c0 += SUB) {
          in_q &= pending;
          if (!__any_sync(FULL, in_q != 0u)) break;
          unsigned sr = L.reach(sc.sub, n_groups, c0 / SUB, in_q, v,
                                st.groups);
          if (!__any_sync(FULL, sr != 0u)) continue;
          const int c1 = min(c0 + SUB, q_end);
          for (int c = c0; c < c1 && __any_sync(FULL, sr != 0u); c += 4) {
            const int nq = min(4, c1 - c);
            if (counting) {
              st.steps += nq * __reduce_max_sync(FULL, __popc(sr));
            }
            if (sr != 0u) {
              Quad quad;
              quad.load(sc.tris, sc.npad, c);
              st.setups += nq;
              test_quad(quad, nq, L, v, sr, pending, st.tests);
            }
          }
        }
      }
    }
  }
}

// tpl: threads a lane (a power of two <= 32) and the grid from
// accel/ao.py:gather_layout; the layout is the header's.  Dynamic shared
// memory: C x 6 x AO_BLOCK floats of strata, then AO_BLOCK words.  The
// only barriers are the rows' and the counts' sums.
// (kCount: the counters, in an instantiation of their own that may hold
// more registers; without them the compiler drops every count)
template <int C, bool kWantBits, bool kCount>
__global__ void __launch_bounds__(AO_BLOCK, kCount ? 3 : 4)
ao_kernel(const float* __restrict__ rays, const float* __restrict__ jit, int B,
          const int* __restrict__ nact, Scene sc, int ntheta, int nphi,
          float inv_nt, float inv_np, int tpl, float* __restrict__ occ_out,
          int* __restrict__ bits_out, int* __restrict__ stats) {
  extern __shared__ float smem[];
  const Strata v{smem + threadIdx.x};
  unsigned* part = reinterpret_cast<unsigned*>(smem + C * 6 * AO_BLOCK);

  const int tid = threadIdx.x;
  const int lanes = AO_BLOCK / tpl;
  const int i = blockIdx.x * lanes + (tid & (lanes - 1));  // the lane
  const int t = tid / lanes;  // its chunk in the first round
  const int n_live = min(*nact, B);
  const int S = ntheta * nphi;
  if (blockIdx.x * lanes >= n_live) {  // block-uniform: no live lane
    if (i < B) {
      if (t == 0) occ_out[i] = 0.f;
      if constexpr (kWantBits) {
        for (int row = t; row * 32 < S; row += tpl) {
          bits_out[(size_t)row * B + i] = 0;
        }
      }
    }
    return;
  }
  const bool live = i < n_live;
  float r[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) r[c] = live ? rays[(size_t)c * B + i] : 0.f;
  const Lane L{r[0], r[1], r[2], r[9], r[10], r[11]};
  const float u0l = live ? jit[i] : 0.f;
  const float u1l = live ? jit[(size_t)B + i] : 0.f;
  const int n_chunks = (S + C - 1) / C;

  Stats st;
  int occluded = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += tpl) {  // block-uniform rounds
    const int s0 = (c0 + t) * C;  // this thread's first stratum
    unsigned pending = 0u;  // bit q: stratum s0 + q not yet occluded
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int s = s0 + q;
      if (!live || s >= S) continue;
      const float3 d = stratum_dir(s, u0l, u1l, ntheta, inv_nt, inv_np, r);
      v.at(q, 0) = d.x;
      v.at(q, 1) = d.y;
      v.at(q, 2) = d.z;
      v.at(q, 3) = bounded_inv(d.x);
      v.at(q, 4) = bounded_inv(d.y);
      v.at(q, 5) = bounded_inv(d.z);
      pending |= 1u << q;
    }
    const unsigned valid = pending;
    walk(sc, L, v, pending, st, kCount);

    const unsigned hit_bits = valid & ~pending;
    occluded += __popc(hit_bits);
    if constexpr (kWantBits) {
      // the g threads t, t + 1, ... of a lane hold one row's chunks; the
      // first ORs their shares and stores the row
      const int g = min(tpl, 32 / C);
      part[tid] = hit_bits << (s0 & 31);
      __syncthreads();
      if ((t & (g - 1)) == 0 && s0 < S && i < B) {
        unsigned row_bits = 0u;
        for (int u = 0; u < g; ++u) row_bits |= part[tid + u * lanes];
        bits_out[(size_t)(s0 >> 5) * B + i] = (int)row_bits;
      }
      __syncthreads();
    }
  }
  part[tid] = (unsigned)occluded;
  __syncthreads();
  if (t == 0 && i < B) {
    int sum = 0;
    for (int u = 0; u < tpl; ++u) sum += (int)part[tid + u * lanes];
    occ_out[i] = (float)sum;
  }
  if constexpr (kCount) {
    st.store(stats + NSTAT * ((blockIdx.x * AO_BLOCK + tid) >> 5));
  }
}

template <int C, bool kWantBits, bool kCount>
int launch_c(int grid, cudaStream_t s, const float* rays, const float* jit,
             int B, const int* nact, const Scene& sc, int ntheta, int nphi,
             float inv_nt, float inv_np, int tpl, float* occ, int* bits,
             int* stats) {
  const int smem = (C * 6 + 1) * AO_BLOCK * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      ao_kernel<C, kWantBits, kCount>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ao_kernel<C, kWantBits, kCount><<<grid, AO_BLOCK, smem, s>>>(
      rays, jit, B, nact, sc, ntheta, nphi, inv_nt, inv_np, tpl, occ, bits,
      stats);
  return 0;
}

template <bool kWantBits, bool kCount>
int launch(int chunk, int grid, cudaStream_t s, const float* rays,
           const float* jit, int B, const int* nact, const Scene& sc,
           int ntheta, int nphi, float inv_nt, float inv_np, int tpl,
           float* occ, int* bits, int* stats) {
  switch (chunk) {
    case 4:
      return launch_c<4, kWantBits, kCount>(grid, s, rays, jit, B, nact, sc,
                                            ntheta, nphi, inv_nt, inv_np, tpl,
                                            occ, bits, stats);
    case 16:
      return launch_c<16, kWantBits, kCount>(grid, s, rays, jit, B, nact, sc,
                                             ntheta, nphi, inv_nt, inv_np,
                                             tpl, occ, bits, stats);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// The sunsky gather's sky: sky_gather_kernel.
//
// Replaces: no Pallas kernel.  lucille_tpu's dense sunsky gather evaluates
// the sky in jnp glue after the fused gather (_sunsky_megakernel,
// lucille_tpu/transport/ao.py:286-332: a scan over the strata); the
// port's torch counterpart ran ~230 full-width ops a tile, every stratum
// of every lane of the wavefront at once ((64, 518,400) directions on the
// headline tile, missed lanes and occluded strata included).  Contract:
// for each compacted hit lane j < nact, the Preetham sky radiance summed
// over its open strata, those whose bit in kernel 3b's bits rows (the
// compacted-order output above, before any scatter) is clear, along
// stratum s's direction (stratum_dir, ao_kernel's own chain) taken into
// the sky's z-up frame (x, z, y); the sky exactly as
// lights/sunsky.py:PreethamSunSky.sky_rgb writes it (arccos, the Perez
// ratios over their zenith denominators, M1/M2, the folded CIE basis,
// the CIEsystem matrix, the clamp and the horizon test), in f32, each
// operation in its order (a Python constant rounds to f32 as torch rounds
// it; `B / cos_t` is torch's reciprocal times B).  col (B, 3) f32: the
// sum in stratum order, as the plain twin sums
// (accel/ao.py:sky_gather_reference); 0 for lanes at or past nact.
//
// What bounds it on the H100: issued f32 instructions and the special
// function unit.  Each open (lane, stratum) pair takes 167 f32
// operations as the source writes them (a transcendental, a divide, a min,
// max, compare or select counted once: 43 for the direction, 124 for the
// sky and the sum; 2 acosf, 3 cosf, 1 sinf, 6 expf, 2 sqrtf and 9
// divisions among them; chip_smoke.SKY_OPS), many more as issued, since
// a full-precision acosf, expf, cosf or sinf is a dozen or more
// instructions; built with --fmad=false every product and sum issues
// alone.  Nothing is read twice: per lane 9 basis floats, 2 uniforms and
// ceil(S / 32) bits words in, 3 floats out.
//
// What the design does about it:
//   * one thread a lane, its strata in order: the lane's basis, uniforms
//     and three sums stay in registers; the open strata are visited over
//     the set bits of each row's complement (__ffs), so an occluded
//     stratum costs nothing and a warp runs as many evaluations as its
//     lane with the most open strata;
//   * the sky's ~40 constants cross by value in a kernel parameter
//     (SkyParams, in constant memory): no copy to the card and no host
//     sync a tile; the three zenith denominators are computed once a
//     thread with the f32 operations sky_rgb uses (a host double would
//     not round the same way);
//   * full-precision acosf/expf/cosf/sinf/sqrtf (no fast-math intrinsic)
//     and the build's --fmad=false: nothing is evaluated below f32;
//   * counters, only when the caller passes a buffer, in an instantiation
//     of their own: the open (lane, stratum) pairs evaluated and the live
//     lanes, summed a warp and added atomically.

constexpr int SKY_BLOCK = 128;   // threads per block of sky_gather_kernel
constexpr int SKY_NPARAMS = 40;  // floats of SkyParams (ao.py:sky_params)

// a Python float as torch rounds it against an f32 tensor
__host__ __device__ constexpr float f32(double v) {
  return static_cast<float>(v);
}

// The Preetham sky's constants, in accel/ao.py:sky_params's order, each
// the f32 rounding of the PreethamSunSky field.
struct SkyParams {
  float sun[3];       // toward the sun, the sky's z-up frame
  float Yz, xz, yz;   // zenith luminance and chromaticity
  float perez[3][5];  // A, B, C, D, E for Y, x, y
  float theta_s;      // the sun's zenith angle
  float basis[3][3];  // S0, S1, S2 against the CIE weights (X, Y, Z)
  float m[3][3];      // XYZ -> RGB, CIEsystem primaries (row: channel)
};
static_assert(sizeof(SkyParams) == SKY_NPARAMS * sizeof(float),
              "SkyParams is SKY_NPARAMS floats");

// The Perez function's value at the zenith (theta 0, gamma theta_s): the
// denominator of its ratio, as sky_rgb computes it on 0-d f32 tensors.
__device__ __forceinline__ float perez_zenith(const float (&p)[5],
                                              float ths) {
  const float cos_z = fmaxf(cosf(0.0f), f32(1e-4));
  const float cs = cosf(ths);
  return (1.0f + p[0] * expf((1.0f / cos_z) * p[1])) *
         ((1.0f + p[2] * expf(p[3] * ths)) + (p[4] * cs) * cs);
}

// The Perez ratio F(theta, gamma) / F(0, theta_s), its cosines given.
__device__ __forceinline__ float perez_ratio(const float (&p)[5], float den,
                                             float cos_t, float gamma,
                                             float cg) {
  const float num = (1.0f + p[0] * expf((1.0f / cos_t) * p[1])) *
                    ((1.0f + p[2] * expf(p[3] * gamma)) + (p[4] * cg) * cg);
  return num / den;
}

// The sky's RGB radiance along the unit direction (x, y, z) of its z-up
// frame (lights/sunsky.py:PreethamSunSky.sky_rgb); den: the three
// zenith denominators.
__device__ __forceinline__ float3 sky_rgb(const SkyParams& sky,
                                          const float (&den)[3], float x,
                                          float y, float z) {
  const float theta = acosf(fminf(fmaxf(z, -1.0f), 1.0f));
  const float cgamma = fminf(
      fmaxf(x * sky.sun[0] + y * sky.sun[1] + z * sky.sun[2], -1.0f), 1.0f);
  const float gamma = acosf(cgamma);
  const float cos_t = fmaxf(cosf(theta), f32(1e-4));
  const float cg = cosf(gamma);
  const float Y =
      sky.Yz * perez_ratio(sky.perez[0], den[0], cos_t, gamma, cg);
  const float cx =
      sky.xz * perez_ratio(sky.perez[1], den[1], cos_t, gamma, cg);
  const float cy =
      sky.yz * perez_ratio(sky.perez[2], den[2], cos_t, gamma, cg);
  // (x, y, Y) -> a CIE-daylight spectrum's XYZ -> RGB
  float d = (f32(0.0241) + f32(0.2562) * cx) - f32(0.7341) * cy;
  d = fabsf(d) > f32(1e-9) ? d : f32(1e-9);
  const float M1 = ((f32(-1.3515) - f32(1.7703) * cx) + f32(5.9114) * cy) / d;
  const float M2 = ((f32(0.03) - f32(31.4424) * cx) + f32(30.0717) * cy) / d;
  float xyz[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xyz[c] = (sky.basis[0][c] + M1 * sky.basis[1][c]) + M2 * sky.basis[2][c];
  }
  const float ly = fabsf(xyz[1]) > f32(1e-9) ? xyz[1] : 1.0f;
  const float scale = (Y * 1000.0f) / ly;
  const float X = xyz[0] * scale, Yv = xyz[1] * scale, Z = xyz[2] * scale;
  float rgb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = (X * sky.m[c][0] + Yv * sky.m[c][1]) + Z * sky.m[c][2];
    // torch.clamp_min(v, 0) (a NaN stays NaN), then the horizon
    rgb[c] = z > 0.0f ? (v < 0.0f ? 0.0f : v) : 0.0f;
  }
  return make_float3(rgb[0], rgb[1], rgb[2]);
}

// One thread a lane (the header's layout above); counters: [open pairs,
// live lanes] (kCount only).
template <bool kCount>
__global__ void __launch_bounds__(SKY_BLOCK)
sky_gather_kernel(const float* __restrict__ rays,
                  const float* __restrict__ jit, const int* __restrict__ bits,
                  int B, const int* __restrict__ nact, int ntheta, int nphi,
                  float inv_nt, float inv_np, SkyParams sky,
                  float* __restrict__ col,
                  unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * SKY_BLOCK + threadIdx.x;
  const bool live = i < min(*nact, B);
  const int S = ntheta * nphi;
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  int open = 0;
  if (live) {
    float r[12];  // the basis in r[3..11], as ao_kernel holds it
#pragma unroll
    for (int c = 0; c < 12; ++c) r[c] = c < 3 ? 0.0f : rays[(size_t)c * B + i];
    const float u0l = jit[i];
    const float u1l = jit[(size_t)B + i];
    float den[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      den[k] = perez_zenith(sky.perez[k], sky.theta_s);
    }
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int n = min(32, S - s0);
      const unsigned valid = n == 32 ? FULL : (1u << n) - 1u;
      const unsigned open_bits =
          ~static_cast<unsigned>(bits[(size_t)(s0 >> 5) * B + i]) & valid;
      for (unsigned m = open_bits; m != 0u; m &= m - 1u) {
        const int s = s0 + __ffs(m) - 1;
        const float3 d = stratum_dir(s, u0l, u1l, ntheta, inv_nt, inv_np, r);
        // the sky's z-up frame: y and z swapped
        const float3 rgb = sky_rgb(sky, den, d.x, d.z, d.y);
        acc.x = acc.x + rgb.x;
        acc.y = acc.y + rgb.y;
        acc.z = acc.z + rgb.z;
        if constexpr (kCount) ++open;
      }
    }
  }
  if (i < B) {
    col[(size_t)i * 3 + 0] = acc.x;
    col[(size_t)i * 3 + 1] = acc.y;
    col[(size_t)i * 3 + 2] = acc.z;
  }
  if constexpr (kCount) {
    const int pairs = __reduce_add_sync(FULL, open);
    const int lanes = __reduce_add_sync(FULL, live ? 1 : 0);
    if ((threadIdx.x & 31) == 0 && lanes > 0) {
      atomicAdd(counters, static_cast<unsigned long long>(pairs));
      atomicAdd(counters + 1, static_cast<unsigned long long>(lanes));
    }
  }
}

template <bool kCount>
void launch_sky(cudaStream_t s, const float* rays, const float* jit,
               const int* bits, int B, const int* nact, int ntheta, int nphi,
               float inv_nt, float inv_np, const SkyParams& sky, float* col,
               unsigned long long* counters) {
  const int grid = (B + SKY_BLOCK - 1) / SKY_BLOCK;
  sky_gather_kernel<kCount><<<grid, SKY_BLOCK, 0, s>>>(
      rays, jit, bits, B, nact, ntheta, nphi, inv_nt, inv_np, sky, col,
      counters);
}

}  // namespace

// n_tris: the real triangles, the first columns of tris; sub: the boxes
// of its SUB-triangle groups (8 x npad / SUB); chunk (strata a thread),
// tpl (threads a lane) and grid from accel/ao.py:gather_layout; bits:
// ceil(S / 32) x B int32 rows, or null for the counts alone; stats: NSTAT
// ints a warp (grid x AO_BLOCK / 32 warps, zeroed: a warp without a live
// lane leaves its own), or null (no counters)
extern "C" int lt_ao_occlusion(const float* rays, const float* jit, int B,
                               const int* nact, const float* tris, int npad,
                               int n_tris, const float* boxes, int n_tiles,
                               const float* sboxes, int n_super,
                               const float* sub, int ntheta, int nphi,
                               float inv_ntheta, float inv_nphi, int chunk,
                               int tpl, int grid, float* occ, int* bits,
                               int* stats, void* stream) {
  if (B <= 0) return 0;
  if (tpl < 1 || tpl > 32 || (tpl & (tpl - 1)) != 0 || n_tris < 0 ||
      n_tris > npad || npad != n_tiles * TC ||
      n_super != (n_tiles + SUPER - 1) / SUPER ||
      (long long)grid * (AO_BLOCK / tpl) < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scene sc{tris, npad, n_tris, boxes, n_tiles, sboxes, n_super, sub};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = bits != nullptr
                     ? (stats != nullptr ? launch<true, true>
                                         : launch<true, false>)
                     : (stats != nullptr ? launch<false, true>
                                         : launch<false, false>);
  const int err = go(chunk, grid, s, rays, jit, B, nact, sc, ntheta, nphi,
                     inv_ntheta, inv_nphi, tpl, occ, bits, stats);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// rays (12, B) and jit (2, B) as lt_ao_occlusion takes them, bits its
// ceil(S / 32) x B rows, all in compacted lane order; params: the host's
// nparams floats of SkyParams (accel/ao.py:sky_params), copied into the
// kernel's parameter; col: B x 3 floats; counters: 2 unsigned 64-bit ints
// (open pairs, live lanes), zeroed, or null (no counters)
extern "C" int lt_sky_gather(const float* rays, const float* jit,
                             const int* bits, int B, const int* nact,
                             int ntheta, int nphi, float inv_ntheta,
                             float inv_nphi, const float* params, int nparams,
                             float* col, unsigned long long* counters,
                             void* stream) {
  if (nparams != SKY_NPARAMS || ntheta < 1 || nphi < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return 0;
  SkyParams sky;
  memcpy(&sky, params, sizeof sky);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = counters != nullptr ? launch_sky<true> : launch_sky<false>;
  go(s, rays, jit, bits, B, nact, ntheta, nphi, inv_ntheta, inv_nphi, sky, col,
     counters);
  return static_cast<int>(cudaGetLastError());
}
