// Fused ambient-occlusion gather, hand-written for Hopper (sm_90a).
//
// Replaces: lucille_tpu/accel/pallas_ao.py:_ao_kernel (:109), the Pallas
// TPU kernel behind pallas_ao_occlusion (want_bits=False) and
// pallas_ao_occlusion_bits (want_bits=True).  Same contract: for each
// compacted hit lane j < nact, the number of its S = ntheta * nphi
// stratified cosine directions that hit a triangle; 0 for lanes at or past
// nact.  With the bits output (template flag kWantBits) also which of them:
// ceil(S / 32) int32 rows in compacted lane order, bit s % 32 of row s / 32
// set when stratum s is occluded, every row 0 for lanes at or past nact.  Stratum s of lane j uses the lane's two
// uniforms (u0, u1) = jitter[:, j], shifted by the R2 Cranley-Patterson
// offsets frac(s * a1), frac(s * a2); cos_t = sqrt((i + u0) / ntheta),
// phi = 2 pi (j' + u1) / nphi, lz = sqrt(max(1 - z0, 0)), rotated into the
// lane's basis (b0, b1, b2).  The hit test is the signed-volume form:
// U, V triple products, W = dn - U - V, a hit needs U, V, W of one sign,
// s_n * dn > 0 and |dn| > 1e-14.  All-zero pad triangles never occlude.
//
// What bounds it on the H100: f32 ALU work per (lane, stratum, triangle):
// three 3-term dot products and the sign tests, ~25 operations.  The
// triangles of a <= 16384-triangle scene (<= 1 MB packed) sit in L2.
//
// What the design does about it:
//   * one thread per compacted lane, 128 lanes per block;
//   * strata run in chunks of CH = 16 whose directions live in registers,
//     so any S works (S = 256 for --gather-rays 256) without a cap;
//   * for each chunk, triangle tiles of 128 are staged in shared memory
//     ([v0 | v1 | v2 | n], a broadcast read per triangle), and the
//     origin-only terms (vertex offsets, two cross products, s_n) are
//     computed once per (triangle, lane) and reused by the chunk's strata;
//   * a per-lane mask of still-unoccluded strata lets an occluded stratum
//     drop out, and a lane whose chunk is fully occluded stops testing;
//     with kWantBits each finished chunk's 16 occluded bits go into a
//     register row, stored when it is full (CH divides 32, so a chunk never
//     straddles two rows); the plain instantiations compile none of it;
//   * culls per lane, all conservative: a tangent-plane test against the
//     16-tile supertile box and then the tile box (hemisphere directions
//     satisfy d . n >= 0, so a box wholly below the lane's tangent plane
//     cannot occlude it), then, from 8 tiles, a slab test of each pending
//     stratum's ray against the tile box; only strata that reach the box
//     are tested against its triangles.  A block stages a tile only if
//     some lane still wants it.
//
// Built with --fmad=false so every product and sum rounds separately, as
// in the plain torch twin (accel/ao.py: ao_occlusion_reference).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 128;        // triangles per tile
constexpr int SUPER = 16;      // tiles per supertile
constexpr int AO_BLOCK = 128;  // lanes per block
constexpr int CH = 16;         // strata per register chunk
// per-stratum slab culls pay from this many tiles; below it their
// reciprocals cost more than they skip.  The kernel is instantiated with
// and without them, so the smaller scenes do not pay the culled variant's
// registers either (96 against 156 a thread).
constexpr int STRATUM_CULL_MIN_TILES = 8;
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

template <bool kStratumCull, bool kWantBits>
__global__ void __launch_bounds__(AO_BLOCK)
ao_kernel(const float* __restrict__ rays, const float* __restrict__ jit, int B,
          const int* __restrict__ nact, const float* __restrict__ tris,
          int npad, const float* __restrict__ boxes, int n_tiles,
          const float* __restrict__ sboxes, int n_super, int ntheta, int nphi,
          float inv_nt, float inv_np, float* __restrict__ occ_out,
          int* __restrict__ bits_out) {
  __shared__ float s[12][TC];  // v0, v1, v2, n of one tile, component-major

  const int i = blockIdx.x * AO_BLOCK + threadIdx.x;
  const int n_live = *nact;
  const int S = ntheta * nphi;
  if (blockIdx.x * AO_BLOCK >= n_live) {  // block-uniform: no live lane
    if (i < B) {
      occ_out[i] = 0.f;
      if constexpr (kWantBits) {
        for (int row = 0; row * 32 < S; ++row) bits_out[(size_t)row * B + i] = 0;
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

  int occluded = 0;
  unsigned row_bits = 0u;  // kWantBits: the occluded bits of the open row
  for (int c0 = 0; c0 < S; c0 += CH) {
    float wx[CH], wy[CH], wz[CH];
    unsigned pending = 0u;  // bit q: stratum c0 + q not yet occluded
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int st = c0 + q;
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
      wx[q] = lx * r[3] + ly * r[6] + lz * r[9];
      wy[q] = lx * r[4] + ly * r[7] + lz * r[10];
      wz[q] = lx * r[5] + ly * r[8] + lz * r[11];
      if (live && st < S) pending |= 1u << q;
    }
    const unsigned valid = pending;

    for (int sk = 0; sk < n_super; ++sk) {
      const bool s_up = pending != 0u &&
          above_plane(sboxes, n_super, sk, ox, oy, oz, b2x, b2y, b2z);
      if (!__syncthreads_or(s_up)) continue;  // block-uniform
      const int k_end = min(n_tiles, (sk + 1) * SUPER);
      for (int k = sk * SUPER; k < k_end; ++k) {
        // strata of this lane whose ray reaches tile k's box
        unsigned reach = 0u;
        if (s_up && pending != 0u &&
            above_plane(boxes, n_tiles, k, ox, oy, oz, b2x, b2y, b2z)) {
          reach = pending;
        }
        if (kStratumCull && reach != 0u) {
          reach = 0u;
          const float bminx = boxes[0 * n_tiles + k];
          const float bminy = boxes[1 * n_tiles + k];
          const float bminz = boxes[2 * n_tiles + k];
          const float bmaxx = boxes[3 * n_tiles + k];
          const float bmaxy = boxes[4 * n_tiles + k];
          const float bmaxz = boxes[5 * n_tiles + k];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            if (!((pending >> q) & 1u)) continue;
            const float ix = bounded_inv(wx[q]);
            const float iy = bounded_inv(wy[q]);
            const float iz = bounded_inv(wz[q]);
            const float t0x = (bminx - ox) * ix, t1x = (bmaxx - ox) * ix;
            const float t0y = (bminy - oy) * iy, t1y = (bmaxy - oy) * iy;
            const float t0z = (bminz - oz) * iz, t1z = (bmaxz - oz) * iz;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                   fminf(t0z, t1z));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fmaxf(t0z, t1z));
            if (tn <= tf && tf > 0.f) reach |= 1u << q;
          }
        }
        const bool want = reach != 0u;
        if (!__syncthreads_or(want)) continue;  // block-uniform
        for (int e = threadIdx.x; e < 12 * TC; e += AO_BLOCK) {
          const int rr = e / TC, cc = e - rr * TC;
          s[rr][cc] = tris[(size_t)rr * npad + (size_t)k * TC + cc];
        }
        __syncthreads();
        if (want) {
          for (int j = 0; j < TC && reach != 0u; ++j) {
            const float pax = s[0][j] - ox, pay = s[1][j] - oy, paz = s[2][j] - oz;
            const float pbx = s[3][j] - ox, pby = s[4][j] - oy, pbz = s[5][j] - oz;
            const float pcx = s[6][j] - ox, pcy = s[7][j] - oy, pcz = s[8][j] - oz;
            const float nx = s[9][j], ny = s[10][j], nz = s[11][j];
            const float cbcx = pby * pcz - pbz * pcy;
            const float cbcy = pbz * pcx - pbx * pcz;
            const float cbcz = pbx * pcy - pby * pcx;
            const float ccax = pcy * paz - pcz * pay;
            const float ccay = pcz * pax - pcx * paz;
            const float ccaz = pcx * pay - pcy * pax;
            const float s_n = pax * nx + pay * ny + paz * nz;
#pragma unroll
            for (int q = 0; q < CH; ++q) {
              if (!((reach >> q) & 1u)) continue;
              const float U = wx[q] * cbcx + wy[q] * cbcy + wz[q] * cbcz;
              const float V = wx[q] * ccax + wy[q] * ccay + wz[q] * ccaz;
              const float dn = wx[q] * nx + wy[q] * ny + wz[q] * nz;
              const float W = dn - U - V;
              const bool inside = fminf(fminf(U, V), W) >= 0.f ||
                                  fmaxf(fmaxf(U, V), W) <= 0.f;
              if (inside && s_n * dn > 0.f && fabsf(dn) > DET_EPS) {
                pending &= ~(1u << q);
                reach &= ~(1u << q);
              }
            }
          }
        }
        __syncthreads();
      }
    }
    occluded += __popc(valid & ~pending);
    if constexpr (kWantBits) {
      row_bits |= (valid & ~pending) << (c0 & 31);
      if (((c0 + CH) & 31) == 0 || c0 + CH >= S) {  // the row is complete
        if (i < B) bits_out[(size_t)(c0 >> 5) * B + i] = (int)row_bits;
        row_bits = 0u;
      }
    }
  }
  if (i < B) occ_out[i] = live ? (float)occluded : 0.f;
}

template <bool kWantBits>
void launch(bool stratum_cull, int grid, cudaStream_t s, const float* rays,
            const float* jit, int B, const int* nact, const float* tris,
            int npad, const float* boxes, int n_tiles, const float* sboxes,
            int n_super, int ntheta, int nphi, float inv_nt, float inv_np,
            float* occ, int* bits) {
  if (stratum_cull) {
    ao_kernel<true, kWantBits><<<grid, AO_BLOCK, 0, s>>>(
        rays, jit, B, nact, tris, npad, boxes, n_tiles, sboxes, n_super,
        ntheta, nphi, inv_nt, inv_np, occ, bits);
  } else {
    ao_kernel<false, kWantBits><<<grid, AO_BLOCK, 0, s>>>(
        rays, jit, B, nact, tris, npad, boxes, n_tiles, sboxes, n_super,
        ntheta, nphi, inv_nt, inv_np, occ, bits);
  }
}

}  // namespace

// bits: ceil(S / 32) x B int32 rows, or null for the counts alone
extern "C" int lt_ao_occlusion(const float* rays, const float* jit, int B,
                               const int* nact, const float* tris, int npad,
                               const float* boxes, int n_tiles,
                               const float* sboxes, int n_super, int ntheta,
                               int nphi, float inv_ntheta, float inv_nphi,
                               float* occ, int* bits, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + AO_BLOCK - 1) / AO_BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cull = n_tiles >= STRATUM_CULL_MIN_TILES;
  if (bits != nullptr) {
    launch<true>(cull, grid, s, rays, jit, B, nact, tris, npad, boxes,
                 n_tiles, sboxes, n_super, ntheta, nphi, inv_ntheta,
                 inv_nphi, occ, bits);
  } else {
    launch<false>(cull, grid, s, rays, jit, B, nact, tris, npad, boxes,
                  n_tiles, sboxes, n_super, ntheta, nphi, inv_ntheta,
                  inv_nphi, occ, bits);
  }
  return static_cast<int>(cudaGetLastError());
}
