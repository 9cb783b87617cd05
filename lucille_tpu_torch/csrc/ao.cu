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
// |dn| > 1e-14.  All-zero pad triangles never occlude.
//
// What bounds it on the H100: f32 ALU work per (lane, stratum, triangle):
// three 3-term dot products and the sign tests, ~30 operations.  Built
// with --fmad=false (the twin's roundings), each issues as its own
// instruction, so ~2x the f32 peak's bound is its floor.  The triangles of
// a <= 16384-triangle scene (<= 1 MB packed) sit in L2.
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
//   * a thread's directions live in shared memory, indexed by stratum, and
//     every loop runs over the set bits of a mask (__ffs), so an occluded
//     stratum stops costing at its occluder and one whose ray misses a box
//     is never tested against what is in it;
//   * culls, all conservative: per lane a tangent-plane test against the
//     16-tile supertile box and the tile box (hemisphere directions
//     satisfy d . n >= 0, so a box wholly below the lane's tangent plane
//     cannot occlude it), then per stratum a slab test against the tile
//     box and against the box of each SUB-triangle group in it;
//   * triangle tiles of 128 ([v0 | v1 | v2 | n], component-major, a
//     broadcast read per triangle) are copied to shared memory by
//     cp.async: a scene of at most NBUF tiles whole, once a block, which
//     each warp then walks at its own pace; a larger one through a ring
//     of two buffers, tile k + 1's copy in flight while tile k is tested,
//     one block vote a tile both deciding whether k + 1 is wanted (from
//     the strata still pending before tile k: a superset, so the answer
//     stays exact) and publishing tile k;
//   * the origin-only terms (vertex offsets, two cross products, s_n) are
//     computed once per (triangle, thread) and reused by its strata;
//   * tiles past the scene's real triangles are never staged, and a tile's
//     loop stops at its last real one (pad slots never occlude).
//
// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twin (accel/ao.py: ao_occlusion_reference).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 128;        // triangles per tile
constexpr int SUPER = 16;      // tiles per supertile
constexpr int SUB = 8;         // triangles per sub-tile box (accel/pack.py)
constexpr int AO_BLOCK = 128;  // threads per block (accel/ao.py: AO_BLOCK)
constexpr int NBUF = 3;        // tile buffers: the largest scene staged whole
constexpr float DET_EPS = 1e-14f;
constexpr float R2_A1 = 0.7548776662466927f;
constexpr float R2_A2 = 0.5698402909980532f;
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ float bounded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

// Is the corner of box k that is farthest along n on or above the plane
// through o with normal n?  Rows of `box` are [min xyz | max xyz].
__device__ __forceinline__ bool above_plane(const float* __restrict__ box,
                                            int stride, int k, float ox,
                                            float oy, float oz, float nx,
                                            float ny, float nz) {
  const float cx = nx > 0.f ? box[3 * stride + k] : box[0 * stride + k];
  const float cy = ny > 0.f ? box[4 * stride + k] : box[1 * stride + k];
  const float cz = nz > 0.f ? box[5 * stride + k] : box[2 * stride + k];
  return (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz >= 0.f;
}

// Tile k ([12][TC] floats of the pack) into a shared buffer, 16 bytes a
// cp.async, as one commit group of this thread.
__device__ __forceinline__ void stage_tile(float (*dst)[TC],
                                           const float* __restrict__ tris,
                                           int npad, int k) {
  for (int e = threadIdx.x; e < 12 * TC / 4; e += AO_BLOCK) {
    const int row = e / (TC / 4), col = (e % (TC / 4)) * 4;
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(&dst[row][col]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(tris + (size_t)row * npad + (size_t)k * TC + col)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The strata of `mask` whose rays reach box k (rows [min xyz | max xyz],
// stride n): a slab test of each against the box.
__device__ __forceinline__ unsigned slab_reach(const float* __restrict__ box,
                                               int n, int k, unsigned mask,
                                               float ox, float oy, float oz,
                                               float (*dir)[3][AO_BLOCK]) {
  const float bminx = box[0 * n + k];
  const float bminy = box[1 * n + k];
  const float bminz = box[2 * n + k];
  const float bmaxx = box[3 * n + k];
  const float bmaxy = box[4 * n + k];
  const float bmaxz = box[5 * n + k];
  const int tid = threadIdx.x;
  unsigned reach = 0u;
  for (unsigned m = mask; m != 0u; m &= m - 1u) {
    const int q = __ffs(m) - 1;
    const float ix = bounded_inv(dir[q][0][tid]);
    const float iy = bounded_inv(dir[q][1][tid]);
    const float iz = bounded_inv(dir[q][2][tid]);
    const float t0x = (bminx - ox) * ix, t1x = (bmaxx - ox) * ix;
    const float t0y = (bminy - oy) * iy, t1y = (bmaxy - oy) * iy;
    const float t0z = (bminz - oz) * iz, t1z = (bmaxz - oz) * iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
    if (tn <= tf && tf > 0.f) reach |= 1u << q;
  }
  return reach;
}

// The strata of `pending` whose rays may hit tile k: none if the lane's
// tangent plane is above the tile's supertile or the tile, else those
// whose ray reaches the tile's box.
__device__ __forceinline__ unsigned tile_reach(
    int k, unsigned pending, const float* __restrict__ boxes, int n_tiles,
    const float* __restrict__ sboxes, int n_super, float ox, float oy,
    float oz, float nx, float ny, float nz, float (*dir)[3][AO_BLOCK]) {
  if (pending == 0u ||
      !above_plane(sboxes, n_super, k / SUPER, ox, oy, oz, nx, ny, nz) ||
      !above_plane(boxes, n_tiles, k, ox, oy, oz, nx, ny, nz)) {
    return 0u;
  }
  return slab_reach(boxes, n_tiles, k, pending, ox, oy, oz, dir);
}

// Tile k's triangles s[12][TC] (its first jn real) against the strata of
// `reach`, SUB triangles at a time, each group against the strata that
// reach its box (sub, stride n_sub): an occluded stratum leaves `pending`.
__device__ __forceinline__ void test_tile(float (*s)[TC], int k, int jn,
                                          unsigned reach, unsigned& pending,
                                          const float* __restrict__ sub,
                                          int n_sub, float ox, float oy,
                                          float oz,
                                          float (*dir)[3][AO_BLOCK]) {
  const int tid = threadIdx.x;
  for (int j0 = 0; j0 < jn && (reach &= pending) != 0u; j0 += SUB) {
    unsigned sr = slab_reach(sub, n_sub, k * (TC / SUB) + j0 / SUB, reach, ox,
                             oy, oz, dir);
    const int j1 = min(j0 + SUB, jn);
    for (int j = j0; j < j1 && sr != 0u; ++j) {
      const float pax = s[0][j] - ox, pay = s[1][j] - oy;
      const float paz = s[2][j] - oz, pbx = s[3][j] - ox;
      const float pby = s[4][j] - oy, pbz = s[5][j] - oz;
      const float pcx = s[6][j] - ox, pcy = s[7][j] - oy;
      const float pcz = s[8][j] - oz;
      const float nx = s[9][j], ny = s[10][j], nz = s[11][j];
      const float cbcx = pby * pcz - pbz * pcy;
      const float cbcy = pbz * pcx - pbx * pcz;
      const float cbcz = pbx * pcy - pby * pcx;
      const float ccax = pcy * paz - pcz * pay;
      const float ccay = pcz * pax - pcx * paz;
      const float ccaz = pcx * pay - pcy * pax;
      const float s_n = pax * nx + pay * ny + paz * nz;
      for (unsigned m = sr; m != 0u; m &= m - 1u) {
        const int q = __ffs(m) - 1;
        const float wx = dir[q][0][tid];
        const float wy = dir[q][1][tid];
        const float wz = dir[q][2][tid];
        const float U = wx * cbcx + wy * cbcy + wz * cbcz;
        const float V = wx * ccax + wy * ccay + wz * ccaz;
        const float dn = wx * nx + wy * ny + wz * nz;
        const float W = dn - U - V;
        const bool inside = fminf(fminf(U, V), W) >= 0.f ||
                            fmaxf(fmaxf(U, V), W) <= 0.f;
        if (inside && s_n * dn > 0.f && fabsf(dn) > DET_EPS) {
          pending &= ~(1u << q);
          sr &= ~(1u << q);
        }
      }
    }
  }
}

// tpl: threads a lane (a power of two <= 32) and the grid from
// accel/ao.py:gather_layout; the layout is the header's.  Every loop with
// a barrier is block-uniform.
template <int C, bool kWantBits>
__global__ void __launch_bounds__(AO_BLOCK, 4)
ao_kernel(const float* __restrict__ rays, const float* __restrict__ jit, int B,
          const int* __restrict__ nact, const float* __restrict__ tris,
          int npad, int n_tris, const float* __restrict__ boxes, int n_tiles,
          const float* __restrict__ sboxes, int n_super,
          const float* __restrict__ sub, int ntheta, int nphi,
          float inv_nt, float inv_np, int tpl, float* __restrict__ occ_out,
          int* __restrict__ bits_out) {
  __shared__ __align__(16) float tile[NBUF][12][TC];
  __shared__ float dir[C][3][AO_BLOCK];  // each thread's chunk, by stratum
  __shared__ unsigned part[AO_BLOCK];  // a thread's share of its lane's row

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
  const float ox = r[0], oy = r[1], oz = r[2];
  const float b2x = r[9], b2y = r[10], b2z = r[11];
  const float u0l = live ? jit[i] : 0.f;
  const float u1l = live ? jit[(size_t)B + i] : 0.f;
  const int n_chunks = (S + C - 1) / C;
  const int n_real = (n_tris + TC - 1) / TC;  // tiles holding a triangle
  const bool whole = n_real <= NBUF;  // the scene staged once, whole
  if (whole) {
    for (int k = 0; k < n_real; ++k) stage_tile(tile[k], tris, npad, k);
    wait_staged();
    __syncthreads();
  }

  int occluded = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += tpl) {  // block-uniform rounds
    const int s0 = (c0 + t) * C;  // this thread's first stratum
    unsigned pending = 0u;  // bit q: stratum s0 + q not yet occluded
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int st = s0 + q;
      if (!live || st >= S) continue;
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
      dir[q][0][tid] = lx * r[3] + ly * r[6] + lz * r[9];
      dir[q][1][tid] = lx * r[4] + ly * r[7] + lz * r[10];
      dir[q][2][tid] = lx * r[5] + ly * r[8] + lz * r[11];
      pending |= 1u << q;
    }
    const unsigned valid = pending;

    if (whole) {  // no barrier: each warp runs at its own pace
      for (int k = 0; k < n_real; ++k) {
        const unsigned reach = tile_reach(
            k, pending, boxes, n_tiles, sboxes, n_super, ox, oy, oz, b2x,
            b2y, b2z, dir);
        test_tile(tile[k], k, min(TC, n_tris - k * TC), reach, pending, sub,
                  n_tiles * (TC / SUB), ox, oy, oz, dir);
      }
    } else {
      // the ring: tile k in buffer k & 1, tile k + 1's copy in flight (the
      // first vote also keeps an earlier round's last tile from being
      // overwritten while it is tested)
      unsigned reach = tile_reach(
          0, pending, boxes, n_tiles, sboxes, n_super, ox, oy, oz, b2x, b2y,
          b2z, dir);
      bool want = __syncthreads_or(reach != 0u);
      if (want) stage_tile(tile[0], tris, npad, 0);
      for (int k = 0; k < n_real; ++k) {
        // from the strata pending before tile k: a superset of tile k + 1's
        const unsigned reach_next = k + 1 < n_real
            ? tile_reach(k + 1, pending, boxes, n_tiles,
                                       sboxes, n_super, ox, oy, oz, b2x, b2y,
                                       b2z, dir)
            : 0u;
        wait_staged();  // this thread's part of tile k
        // one vote: tile k is in for every thread, buffer (k + 1) & 1 free
        const bool want_next = __syncthreads_or(reach_next != 0u);
        if (want_next) stage_tile(tile[(k + 1) & 1], tris, npad, k + 1);
        if (want) {
          test_tile(tile[k & 1], k, min(TC, n_tris - k * TC), reach, pending,
                    sub, n_tiles * (TC / SUB), ox, oy, oz, dir);
        }
        reach = reach_next;
        want = want_next;
      }
    }

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
}

template <bool kWantBits>
int launch(int chunk, int grid, cudaStream_t s, const float* rays,
           const float* jit, int B, const int* nact, const float* tris,
           int npad, int n_tris, const float* boxes, int n_tiles,
           const float* sboxes, int n_super, const float* sub, int ntheta,
           int nphi, float inv_nt, float inv_np, int tpl, float* occ,
           int* bits) {
  switch (chunk) {
    case 4:
      ao_kernel<4, kWantBits><<<grid, AO_BLOCK, 0, s>>>(
          rays, jit, B, nact, tris, npad, n_tris, boxes, n_tiles, sboxes,
          n_super, sub, ntheta, nphi, inv_nt, inv_np, tpl, occ, bits);
      return 0;
    case 16:
      ao_kernel<16, kWantBits><<<grid, AO_BLOCK, 0, s>>>(
          rays, jit, B, nact, tris, npad, n_tris, boxes, n_tiles, sboxes,
          n_super, sub, ntheta, nphi, inv_nt, inv_np, tpl, occ, bits);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// n_tris: the real triangles, the first columns of tris; sub: the boxes
// of its SUB-triangle groups (8 x npad / SUB); chunk (strata a thread),
// tpl (threads a lane) and grid from accel/ao.py:gather_layout; bits:
// ceil(S / 32) x B int32 rows, or null for the counts alone
extern "C" int lt_ao_occlusion(const float* rays, const float* jit, int B,
                               const int* nact, const float* tris, int npad,
                               int n_tris, const float* boxes, int n_tiles,
                               const float* sboxes, int n_super,
                               const float* sub, int ntheta, int nphi,
                               float inv_ntheta, float inv_nphi, int chunk,
                               int tpl, int grid, float* occ, int* bits,
                               void* stream) {
  if (B <= 0) return 0;
  if (tpl < 1 || tpl > 32 || (tpl & (tpl - 1)) != 0 || n_tris < 0 ||
      n_tris > npad || (long long)grid * (AO_BLOCK / tpl) < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      bits != nullptr
          ? launch<true>(chunk, grid, s, rays, jit, B, nact, tris, npad,
                         n_tris, boxes, n_tiles, sboxes, n_super, sub, ntheta,
                         nphi, inv_ntheta, inv_nphi, tpl, occ, bits)
          : launch<false>(chunk, grid, s, rays, jit, B, nact, tris, npad,
                          n_tris, boxes, n_tiles, sboxes, n_super, sub,
                          ntheta, nphi, inv_ntheta, inv_nphi, tpl, occ, bits);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
