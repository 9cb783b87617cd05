// Uniform-grid closest hit and any-hit: the Amanatides-Woo 3D-DDA walk of
// lucille_tpu's grid, a group of G lanes a ray, hand-written for Hopper
// (sm_90a).
//
// Stands for a JAX loop, not a Pallas kernel: lucille_tpu/accel/ugrid.py's
// `_traverse` (:166-268) advances the whole wavefront in lock-step inside
// one lax.while_loop until no ray is alive.  A ray's state there depends
// on that ray alone, so the walk below, run to its end by one group of
// lanes, computes what the lock-step loop computes for that ray:
//   * entry (`_dda_init`, :128-155): the slab test against the grid's
//     box, the entry cell from the point 1e-6 past the entry along the
//     ray, the per-axis step, next boundary distance and cell width in t
//     (1e30 where the step is 0 or |dir| <= 1e-20);
//   * a step either tests the next chunk of K = 4 of the cell's triangles
//     in CSR order (Moller-Trumbore, |det| > 1e-14, u, v >= 0, u + v <= 1,
//     t > 0, t < t_best and t < tmax: the first tested wins a tie), or,
//     once the cell is exhausted, advances to the neighbouring cell along
//     the axis of the nearest boundary (the lowest axis among equal
//     distances).  The closest hit settles when its best t is at or before
//     that boundary, or when the boundary lies beyond tmax; any walk ends
//     when it leaves the grid; the any-hit ends after the chunk that holds
//     its first hit;
//   * counters, those of the reference's ri_statistic_t (ntesttris,
//     ngridtravs): `ntests` counts the triangle slots tested (a chunk's
//     min(4, slots left)), `ntrav` the cell advances; they depend on the
//     ray's own walk alone, so they equal lucille_tpu's exactly.
// A walk makes at most MAX_ADV = 4 res advances (a walk that moves a cell
// an advance leaves the grid within 3 res; the cap only ends the walk of
// a ray with no usable direction, which the lock-step loop would run
// almost forever).  The plain torch twin (accel/ugrid.py:
// grid_walk_reference) runs the lock-step loop with the same cap.
//
// What bounds it on the H100: not the arithmetic (a test is ~56 f32
// operations and one IEEE divide, built with --fmad=false as the twin
// rounds) and not the bytes (a bundled or terrain grid sits in L2), but
// the latency of the chain of dependent steps along a ray's walk: a
// launch lasts about as long as its longest walks, hundreds of steps on a
// terrain, where most advances enter an empty cell, while one stratum of
// a terrain tile leaves ~10% of the card's resident threads a live ray.
// What the design does about it:
//   * an empty cell costs no cell-list read: the grid's occupancy bitmask
//     (scene.grid_occupied, one bit a cell, <= 32 KB at res 64) stays in
//     L1, and the CSR range is read only for a cell that lists a slot
//     (issued before the settle test, so that the two overlap).  A copy
//     of the mask in each block's shared memory measured slower on the
//     terrain (its 32 KB a block took L1's room and was read anew by each
//     of 4,096 blocks);
//   * a slot is three independent 16-byte loads: the scene's slot-order
//     pack (scene.grid_tris) holds, for CSR slot j, the triangle
//     tri_idx[j] as three float4 (v0 with the id's bits in .w, e1, e2),
//     where the walk used to read the index and then nine scattered
//     floats;
//   * a group of G = 8 lanes walks one ray where the rays walk far and
//     few enough of them leave the card room (a terrain tile; the
//     wrapper's rule, accel/ugrid.py:group_lanes, from the grid's
//     resolution and the wavefront's size): every lane keeps the
//     ray's state, a step tests G consecutive chunks of the cell, lane g
//     the chunk cursor / K + g, its K slots loaded in one round, and an
//     advance runs on through empty cells until the walk enters one that
//     lists a slot.  The closest hit takes the least (t, slot) over the
//     group, which is the first tested among equal t; the any-hit ends at
//     the lowest chunk that hits (a ballot) and counts the slots up to
//     the end of that chunk, as the sequential walk does;
//   * a lane a ray elsewhere (the bundled scene's short walks at any
//     tile, or more rays than the card holds): its slots loaded one by
//     one and an advance a step, which keeps its registers (so its
//     warps) fewer and lets a warp's lanes, each on its own walk, meet
//     again every step (both measured faster there, slower on the
//     terrain);
//   * the per-axis state stays in registers: the step's axis is selected
//     by constant-indexed predicates, never by a run-time index.
// Counters at the level the wrapper asks, an instantiation each: none
// (the any-hit's callers read none), each warp's rays' ntrav and ntests
// (the closest hit's, which the renderer sums), or those and the warp's
// own advance and chunk steps (warp_ntrav, warp_ntests: each issue of the
// advance or the chunk code, whatever lanes it carries), so
// G * ntrav / (32 warp_ntrav) and ntests / (32 K warp_ntests) are the
// walk's SIMT efficiency.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 128;  // threads per block (accel/ugrid.py: BLOCK)
constexpr int K = 4;        // triangles tested a chunk
constexpr int NSTAT = 4;    // counters a warp (accel/isect.py: NSTAT)
constexpr float DET_EPS = 1e-14f;
constexpr float BIG = 1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
// counters a launch reports (accel/ugrid.py: grid_walk_kernel): none, the
// rays' ntrav and ntests, or those and the warps' own steps
constexpr int NONE = 0, RAYS = 1, WARPS = 2;

struct Grid {
  const float4* tris;        // (M, 3) slot-order pack: v0 | id, e1, e2
  const int* cell_start;     // (res^3 + 1,) CSR offsets into the slots
  const unsigned* occupied;  // (ceil(res^3 / 32),) bit c % 32 of word c / 32
  const float* box;          // (6,) grid bbmin xyz, bbmax xyz
  int res;
};

// Moller-Trumbore in the twin's operation order (accel/ugrid.py:
// _mt_single) on one slot of the pack: (hit, t, u, v), the hit without
// the t window.
__device__ __forceinline__ bool mt(float ox, float oy, float oz, float dx,
                                   float dy, float dz, const float4& r0,
                                   const float4& r1, const float4& r2,
                                   float& t, float& u, float& v) {
  const float px = dy * r2.z - dz * r2.y;
  const float py = dz * r2.x - dx * r2.z;
  const float pz = dx * r2.y - dy * r2.x;
  const float a = r1.x * px + r1.y * py + r1.z * pz;
  const bool valid = fabsf(a) > DET_EPS;
  const float inva = valid ? 1.0f / a : 0.0f;
  const float sx = ox - r0.x, sy = oy - r0.y, sz = oz - r0.z;
  const float qx = sy * r1.z - sz * r1.y;
  const float qy = sz * r1.x - sx * r1.z;
  const float qz = sx * r1.y - sy * r1.x;
  u = (sx * px + sy * py + sz * pz) * inva;
  v = (qx * dx + qy * dy + qz * dz) * inva;
  t = (r2.x * qx + r2.y * qy + r2.z * qz) * inva;
  return valid && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f;
}

// Slot j of the slot-order pack: v0 | id, e1, e2.
__device__ __forceinline__ void load_slot(const Grid& g, int j, float4* r) {
  r[0] = __ldg(g.tris + 3 * j);
  r[1] = __ldg(g.tris + 3 * j + 1);
  r[2] = __ldg(g.tris + 3 * j + 2);
}

// One issue of the calling code by the warp: true on the first lane of
// the lanes that run it together.
__device__ __forceinline__ bool warp_issue(int lane) {
  return lane == __ffs(__activemask()) - 1;
}

template <bool kAny, int G, int kStats>
__global__ void __launch_bounds__(BLOCK, 1)
    grid_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                const float* __restrict__ tmax,
                const unsigned char* __restrict__ active, int B, Grid g,
                float* __restrict__ t_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ tri_out,
                unsigned char* __restrict__ occ_out, int* __restrict__ stats) {
  const int res = g.res;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // the lane's place in its group
  const unsigned gmask = (FULL >> (32 - G)) << (lane - sub);
  const int i = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const bool ray = i < B;
  float t_best = INFINITY, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  bool found_any = false;
  int ntests = 0, ntrav = 0, warp_trav = 0, warp_tests = 0;
  bool alive = ray && (active == nullptr || active[i]);
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 1.f};
  float t_cap = INFINITY;
  if (alive) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = org[3 * i + c];
      d[c] = dir[3 * i + c];
    }
    if (tmax != nullptr) t_cap = tmax[i];
  }
  // entry (`_dda_init`)
  float gmin[3], w[3], invd[3], tn[3], tf[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gmin[c] = __ldg(g.box + c);
    const float gmax = __ldg(g.box + 3 + c);
    w[c] = (gmax - gmin[c]) / (float)res;
    const bool safe = fabsf(d[c]) > 1e-20f;
    invd[c] = safe ? 1.0f / d[c] : BIG;
    const float t0 = (gmin[c] - o[c]) * invd[c];
    const float t1 = (gmax - o[c]) * invd[c];
    tn[c] = fminf(t0, t1);
    tf[c] = fmaxf(t0, t1);
  }
  const float tnear = fmaxf(fmaxf(tn[0], tn[1]), tn[2]);
  const float tfar = fminf(fminf(tf[0], tf[1]), tf[2]);
  alive = alive && tnear <= tfar && tfar > 0.f;
  const float t_enter = fmaxf(tnear, 0.f);
  int cell[3];
  float tmaxv[3], tdelta[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = o[c] + (t_enter + 1e-6f) * d[c];
    const float f = fminf(fmaxf(floorf((p - gmin[c]) / w[c]), 0.f),
                          (float)(res - 1));
    cell[c] = (int)f;
    const bool moving = d[c] > 0.f || d[c] < 0.f;  // the step's sign
    const float next_b = gmin[c] + (float)(cell[c] + (d[c] > 0.f)) * w[c];
    tmaxv[c] = moving ? (next_b - o[c]) * invd[c] : BIG;
    tdelta[c] = moving ? w[c] * fabsf(invd[c]) : BIG;
  }
  int cursor = 0, cend = 0;
  if (alive) {
    const int cid = cell[0] + res * (cell[1] + res * cell[2]);
    if ((__ldg(g.occupied + (cid >> 5)) >> (cid & 31)) & 1u) {
      cursor = __ldg(g.cell_start + cid);
      cend = __ldg(g.cell_start + cid + 1);
    }
  }
  const int max_adv = 4 * res;
  while (alive) {
    if (cursor < cend) {  // G chunks of K slots from the cell, one a lane
      if (kStats == WARPS && warp_issue(lane)) ++warp_tests;
      const int left = cend - cursor;
      const int first = cursor + sub * K;
      // this lane's best: for one lane a ray the ray's own; for a group,
      // the lane's (t, slot), reduced over the group below
      float bt = t_best, bu = u_best, bv = v_best;
      int bslot = INT_MAX, btri = tri_best;
      bool found = false;
      // a group loads its lane's slots in one round (a slot past the
      // cell's end reads the cell's last, untested); a lane a ray, slot
      // by slot, which keeps its registers, and so its warps, fewer
      float4 r[K][3];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = min(first + k, cend - 1);
        if (G > 1) load_slot(g, j, r[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = first + k;
        if (j < cend) {
          if (G == 1) load_slot(g, j, r[k]);
          float tt, uu, vv;
          const bool hh = mt(o[0], o[1], o[2], d[0], d[1], d[2], r[k][0],
                             r[k][1], r[k][2], tt, uu, vv);
          if (kAny) {  // t_best stays +inf until the walk ends
            found = found || (hh && tt > 0.f && tt < t_cap);
          } else if (hh && tt > 0.f && tt < bt && tt < t_cap) {
            bt = tt;
            bu = uu;
            bv = vv;
            btri = __float_as_int(r[k][0].w);
            bslot = j;
          }
        }
      }
      if (kAny) {
        unsigned hits = found;
        if (G > 1) hits = __ballot_sync(gmask, found) >> (lane - sub);
        if (hits) {  // the walk ends after the lowest chunk that hits
          ntests += min(left, __ffs(hits) * K);
          found_any = true;
          break;
        }
      } else {
        // the least (t, slot) of the group: the first tested at equal t
#pragma unroll
        for (int off = 1; off < G; off <<= 1) {
          const float ot = __shfl_xor_sync(gmask, bt, off);
          const int os = __shfl_xor_sync(gmask, bslot, off);
          const float ou = __shfl_xor_sync(gmask, bu, off);
          const float ov = __shfl_xor_sync(gmask, bv, off);
          const int otri = __shfl_xor_sync(gmask, btri, off);
          if (ot < bt || (ot == bt && os < bslot)) {
            bt = ot;
            bslot = os;
            bu = ou;
            bv = ov;
            btri = otri;
          }
        }
        t_best = bt;
        u_best = bu;
        v_best = bv;
        tri_best = btri;
      }
      ntests += min(left, G * K);
      cursor += G * K;
      continue;
    }
    // the cell is exhausted: settle, or advance (an empty cell costs an
    // L1 read of the mask); a group runs on until the walk enters a cell
    // that lists a slot, a lane a ray advances once a step, so that the
    // lanes of its warp, each on its own walk, meet again every step
    for (;;) {
      if (kStats == WARPS && warp_issue(lane)) ++warp_trav;
      const float tmin3 = fminf(fminf(tmaxv[0], tmaxv[1]), tmaxv[2]);
      const bool settled = t_best <= tmin3 || tmin3 > t_cap;
      const int axis = (tmaxv[0] <= tmaxv[1] && tmaxv[0] <= tmaxv[2])
                           ? 0
                           : (tmaxv[1] <= tmaxv[2] ? 1 : 2);
      ++ntrav;
      bool out = false;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c == axis) {
          cell[c] += (d[c] > 0.f) - (d[c] < 0.f);
          tmaxv[c] += tdelta[c];
          out = cell[c] < 0 || cell[c] >= res;
        }
      }
      const int cid = cell[0] + res * (cell[1] + res * cell[2]);
      const bool full =
          !out && ((__ldg(g.occupied + (cid >> 5)) >> (cid & 31)) & 1u);
      if (full) {
        cursor = __ldg(g.cell_start + cid);
        cend = __ldg(g.cell_start + cid + 1);
      }
      if (settled || out || ntrav >= max_adv) {
        alive = false;
        break;
      }
      if (full || G == 1) break;
    }
  }
  if (ray && sub == 0) {
    if (kAny) {
      occ_out[i] = found_any ? 1 : 0;
    } else {
      t_out[i] = t_best;
      u_out[i] = u_best;
      v_out[i] = v_best;
      tri_out[i] = tri_best;
    }
  }
  if (kStats == NONE) return;
  // the warp's counters: each ray's once, the warp's own steps
  if (sub != 0) ntrav = ntests = 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ntrav += __shfl_down_sync(FULL, ntrav, off);
    ntests += __shfl_down_sync(FULL, ntests, off);
    warp_trav += __shfl_down_sync(FULL, warp_trav, off);
    warp_tests += __shfl_down_sync(FULL, warp_tests, off);
  }
  if (lane == 0) {
    int* out = stats + NSTAT * ((blockIdx.x * BLOCK + threadIdx.x) >> 5);
    out[0] = ntrav;
    out[1] = ntests;
    out[2] = warp_trav;
    out[3] = warp_tests;
  }
}

template <bool kAny, int G>
void start(int B, const float* org, const float* dir, const float* tmax,
           const unsigned char* active, const Grid& g, float* t, float* u,
           float* v, int* tri, unsigned char* occ, int* stats, int counters,
           cudaStream_t s) {
  const int blocks = (B + BLOCK / G - 1) / (BLOCK / G);
  if (counters == WARPS) {
    grid_kernel<kAny, G, WARPS><<<blocks, BLOCK, 0, s>>>(
        org, dir, tmax, active, B, g, t, u, v, tri, occ, stats);
  } else if (counters == RAYS) {
    grid_kernel<kAny, G, RAYS><<<blocks, BLOCK, 0, s>>>(
        org, dir, tmax, active, B, g, t, u, v, tri, occ, stats);
  } else {
    grid_kernel<kAny, G, NONE><<<blocks, BLOCK, 0, s>>>(
        org, dir, tmax, active, B, g, t, u, v, tri, occ, stats);
  }
}

template <bool kAny>
int launch(int lanes, int B, const float* org, const float* dir,
           const float* tmax, const unsigned char* active, const Grid& g,
           float* t, float* u, float* v, int* tri, unsigned char* occ,
           int* stats, int counters, void* stream) {
  if (B < 0 || g.res < 1 || (kAny ? !occ : !(t && u && v && tri)) ||
      counters < NONE || counters > WARPS || (counters != NONE && !stats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      start<kAny, 1>(B, org, dir, tmax, active, g, t, u, v, tri, occ, stats,
                     counters, s);
      break;
    case 8:
      start<kAny, 8>(B, org, dir, tmax, active, g, t, u, v, tri, occ, stats,
                     counters, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Closest hit of rays org, dir (B, 3) f32 with 0 < t < tmax (tmax (B,) or
// null: unbounded); active (B,) u8 or null, a dead ray walks nothing and
// reports a miss (t = +inf, u = v = 0, tri = -1).  The grid: tris the
// slot-order pack (M, 12) f32, cell_start (res^3 + 1,) i32, occupied the
// bitmask (ceil(res^3 / 32),) i32, box (6,) f32; lanes (1 or 8) a
// ray.  counters: 0 none (stats may be null), 1 each warp's rays' ntrav
// and ntests, 2 those and the warp's advance and chunk steps, into stats,
// NSTAT ints (ntrav, ntests, warp_ntrav, warp_ntests; the last two 0 at
// 1) for each of the launch's 4 ceil(B lanes / 128) warps.
extern "C" int lt_grid_closest_hit(const float* org, const float* dir,
                                   const float* tmax,
                                   const unsigned char* active, int B,
                                   const float* tris, const int* cell_start,
                                   const int* occupied, const float* box,
                                   int res, int lanes, float* t, float* u,
                                   float* v, int* tri, int* stats,
                                   int counters, void* stream) {
  const Grid g{reinterpret_cast<const float4*>(tris), cell_start,
               reinterpret_cast<const unsigned*>(occupied), box, res};
  return launch<false>(lanes, B, org, dir, tmax, active, g, t, u, v, tri,
                       nullptr, stats, counters, stream);
}

// Whether each ray hits a triangle with 0 < t < tmax: occ (B,) u8; a dead
// ray reports 0.  Operands as lt_grid_closest_hit.
extern "C" int lt_grid_any_hit(const float* org, const float* dir,
                               const float* tmax, const unsigned char* active,
                               int B, const float* tris, const int* cell_start,
                               const int* occupied, const float* box, int res,
                               int lanes, unsigned char* occ, int* stats,
                               int counters, void* stream) {
  const Grid g{reinterpret_cast<const float4*>(tris), cell_start,
               reinterpret_cast<const unsigned*>(occupied), box, res};
  return launch<true>(lanes, B, org, dir, tmax, active, g, nullptr, nullptr,
                      nullptr, nullptr, occ, stats, counters, stream);
}
