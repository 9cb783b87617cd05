// Uniform-grid closest hit and any-hit: the Amanatides-Woo 3D-DDA walk of
// lucille_tpu's grid, one thread a ray, hand-written for Hopper (sm_90a).
//
// Stands for a JAX loop, not a Pallas kernel: lucille_tpu/accel/ugrid.py's
// `_traverse` (:166-268) advances the whole wavefront in lock-step inside
// one lax.while_loop until no ray is alive.  A ray's state there depends
// on that ray alone, so the walk below, run to its end by one thread,
// computes what the lock-step loop computes for that ray:
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
//     ray's own walk alone, so they equal lucille_tpu's exactly.  Summed
//     over each warp's lanes into stats[2 * warp + {0, 1}].
// A walk makes at most MAX_ADV = 4 res advances (a walk that moves a cell
// an advance leaves the grid within 3 res; the cap only ends the walk of
// a ray with no usable direction, which the lock-step loop would run
// almost forever).  The plain torch twin (accel/ugrid.py:
// grid_walk_reference) runs the lock-step loop with the same cap.
//
// What bounds it on the H100: the triangle tests and their loads.  A test
// is ~56 f32 operations and one IEEE divide (built with --fmad=false, as
// the twin rounds); each tested slot reads a 4-byte index and three
// 12-byte rows of the triangle's v0 / e1 / e2, gathered (the tables of a
// bundled or terrain scene sit in L2).  One thread a ray keeps the DDA
// exact and simple, but the lanes of a warp walk different cells: the warp
// runs as long as its longest walk, and its loads do not coalesce.  A
// warp-wide walk (a warp on a bundle of rays sharing its cells) is later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 128;  // rays per block (accel/ugrid.py: BLOCK)
constexpr int K = 4;        // triangles tested a step
constexpr float DET_EPS = 1e-14f;
constexpr float BIG = 1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Grid {
  const float* v0;  // (npad, 3) triangle tables, as scene.tri_v0 / e1 / e2
  const float* e1;
  const float* e2;
  const int* cell_start;  // (res^3 + 1,) CSR offsets into tri_idx
  const int* tri_idx;     // (M,) triangle ids, cell-major
  const float* box;       // (6,) grid bbmin xyz, bbmax xyz
  int res;
};

// Moller-Trumbore in the twin's operation order (accel/ugrid.py:
// _mt_single): (hit, t, u, v), the hit without the t window.
__device__ __forceinline__ bool mt(float ox, float oy, float oz, float dx,
                                   float dy, float dz, const Grid& g, int i,
                                   float& t, float& u, float& v) {
  const float v0x = __ldg(g.v0 + 3 * i), v0y = __ldg(g.v0 + 3 * i + 1),
              v0z = __ldg(g.v0 + 3 * i + 2);
  const float e1x = __ldg(g.e1 + 3 * i), e1y = __ldg(g.e1 + 3 * i + 1),
              e1z = __ldg(g.e1 + 3 * i + 2);
  const float e2x = __ldg(g.e2 + 3 * i), e2y = __ldg(g.e2 + 3 * i + 1),
              e2z = __ldg(g.e2 + 3 * i + 2);
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
  return valid && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f;
}

template <bool kAny>
__global__ void __launch_bounds__(BLOCK)
    grid_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                const float* __restrict__ tmax,
                const unsigned char* __restrict__ active, int B, Grid g,
                float* __restrict__ t_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ tri_out,
                unsigned char* __restrict__ occ_out, int* __restrict__ stats) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool lane = i < B;
  const int res = g.res;
  float t_best = INFINITY, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  bool found_any = false;
  int ntests = 0, ntrav = 0;
  bool alive = lane && (active == nullptr || active[i]);
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
  float gmin[3], gmax[3], w[3], invd[3], tn[3], tf[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gmin[c] = __ldg(g.box + c);
    gmax[c] = __ldg(g.box + 3 + c);
    w[c] = (gmax[c] - gmin[c]) / (float)res;
    const bool safe = fabsf(d[c]) > 1e-20f;
    invd[c] = safe ? 1.0f / d[c] : BIG;
    const float t0 = (gmin[c] - o[c]) * invd[c];
    const float t1 = (gmax[c] - o[c]) * invd[c];
    tn[c] = fminf(t0, t1);
    tf[c] = fmaxf(t0, t1);
  }
  const float tnear = fmaxf(fmaxf(tn[0], tn[1]), tn[2]);
  const float tfar = fminf(fminf(tf[0], tf[1]), tf[2]);
  alive = alive && tnear <= tfar && tfar > 0.f;
  const float t_enter = fmaxf(tnear, 0.f);
  int cell[3], step[3];
  float tmaxv[3], tdelta[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = o[c] + (t_enter + 1e-6f) * d[c];
    const float f = fminf(fmaxf(floorf((p - gmin[c]) / w[c]), 0.f),
                          (float)(res - 1));
    cell[c] = (int)f;
    step[c] = d[c] > 0.f ? 1 : (d[c] < 0.f ? -1 : 0);
    const float next_b = gmin[c] + (float)(cell[c] + (step[c] > 0)) * w[c];
    tmaxv[c] = step[c] != 0 ? (next_b - o[c]) * invd[c] : BIG;
    tdelta[c] = step[c] != 0 ? w[c] * fabsf(invd[c]) : BIG;
  }
  int cursor = 0, cend = 0;
  if (alive) {
    const int cid = cell[0] + res * (cell[1] + res * cell[2]);
    cursor = __ldg(g.cell_start + cid);
    cend = __ldg(g.cell_start + cid + 1);
  }
  const int max_adv = 4 * res;
  while (alive) {
    if (cursor < cend) {  // a chunk of K triangles from the cell
      bool found = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = cursor + k;
        if (j < cend) {
          const int ti = __ldg(g.tri_idx + j);
          float tt, uu, vv;
          const bool hh = mt(o[0], o[1], o[2], d[0], d[1], d[2], g, ti, tt,
                             uu, vv);
          if (hh && tt > 0.f && tt < t_best && tt < t_cap) {
            t_best = tt;
            u_best = uu;
            v_best = vv;
            tri_best = ti;
            found = true;
          }
        }
      }
      ntests += min(cend - cursor, K);
      cursor += K;
      if (kAny && found) {
        found_any = true;
        break;
      }
      continue;
    }
    // the cell is exhausted: settle, or step to the next cell
    const float tmin3 = fminf(fminf(tmaxv[0], tmaxv[1]), tmaxv[2]);
    const bool settled = t_best <= tmin3 || tmin3 > t_cap;
    const int axis = (tmaxv[0] <= tmaxv[1] && tmaxv[0] <= tmaxv[2])
                         ? 0
                         : (tmaxv[1] <= tmaxv[2] ? 1 : 2);
    ++ntrav;
    cell[axis] += step[axis];
    tmaxv[axis] += tdelta[axis];
    const bool out = cell[axis] < 0 || cell[axis] >= res;
    if (settled || out || ntrav >= max_adv) break;
    const int cid = cell[0] + res * (cell[1] + res * cell[2]);
    cursor = __ldg(g.cell_start + cid);
    cend = __ldg(g.cell_start + cid + 1);
  }
  if (lane) {
    if (kAny) {
      occ_out[i] = found_any ? 1 : 0;
    } else {
      t_out[i] = t_best;
      u_out[i] = u_best;
      v_out[i] = v_best;
      tri_out[i] = tri_best;
    }
  }
  // the warp's counters
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ntrav += __shfl_down_sync(FULL, ntrav, off);
    ntests += __shfl_down_sync(FULL, ntests, off);
  }
  if ((threadIdx.x & 31) == 0) {
    const int warp = (blockIdx.x * BLOCK + threadIdx.x) >> 5;
    stats[2 * warp + 0] = ntrav;
    stats[2 * warp + 1] = ntests;
  }
}

int launch(bool any, const float* org, const float* dir, const float* tmax,
           const unsigned char* active, int B, const Grid& g, float* t,
           float* u, float* v, int* tri, unsigned char* occ, int* stats,
           void* stream) {
  if (B < 0 || g.res < 1 || !stats || (any ? !occ : !(t && u && v && tri))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + BLOCK - 1) / BLOCK;
  if (any) {
    grid_kernel<true><<<blocks, BLOCK, 0, s>>>(org, dir, tmax, active, B, g,
                                               nullptr, nullptr, nullptr,
                                               nullptr, occ, stats);
  } else {
    grid_kernel<false><<<blocks, BLOCK, 0, s>>>(org, dir, tmax, active, B,
                                                g, t, u, v, tri, nullptr,
                                                stats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Closest hit of rays org, dir (B, 3) f32 with 0 < t < tmax (tmax (B,) or
// null: unbounded); active (B,) u8 or null, a dead ray walks nothing and
// reports a miss (t = +inf, u = v = 0, tri = -1).  stats: 2 ints for each
// of the launch's 4 ceil(B / 128) warps.
extern "C" int lt_grid_closest_hit(const float* org, const float* dir,
                                   const float* tmax,
                                   const unsigned char* active, int B,
                                   const float* v0, const float* e1,
                                   const float* e2, const int* cell_start,
                                   const int* tri_idx, const float* box,
                                   int res, float* t, float* u, float* v,
                                   int* tri, int* stats, void* stream) {
  const Grid g{v0, e1, e2, cell_start, tri_idx, box, res};
  return launch(false, org, dir, tmax, active, B, g, t, u, v, tri, nullptr,
                stats, stream);
}

// Whether each ray hits a triangle with 0 < t < tmax: occ (B,) u8; a dead
// ray reports 0.  Operands as lt_grid_closest_hit.
extern "C" int lt_grid_any_hit(const float* org, const float* dir,
                               const float* tmax, const unsigned char* active,
                               int B, const float* v0, const float* e1,
                               const float* e2, const int* cell_start,
                               const int* tri_idx, const float* box, int res,
                               unsigned char* occ, int* stats, void* stream) {
  const Grid g{v0, e1, e2, cell_start, tri_idx, box, res};
  return launch(true, org, dir, tmax, active, B, g, nullptr, nullptr,
                nullptr, nullptr, occ, stats, stream);
}
