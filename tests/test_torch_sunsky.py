"""Sunsky AO: the dense any-hit, the AO gather's per-stratum bits, the
sky model and the sunsky frame of the port (plain torch twins on the
CPU) against lucille_tpu (its Pallas kernels in interpret mode, fed
JAX's own jitter draw), and the port's frame against CPU-lucille's.

Tolerances:

- any-hit: equal on every live ray, rays aimed at an edge two triangles
  share included (both packages count a hit on either side: the tests
  u, v >= 0 and u + v <= 1 are inclusive).  A dead ray reports False in
  the port; lucille_tpu computes dead rays in its live blocks, or all of
  them below 8 tiles where it ignores the mask, so they are not compared;
- per-stratum bits: the lane order and the raster-order jitter exactly;
  bits equal on >= 99% of the hit lanes, and elsewhere at most one
  stratum apart (a direction differs by an ulp where XLA's and torch's
  cos/sin round differently: the bound test_torch_ao.py holds the counts
  to).  lucille_tpu leaves garbage bits on missed lanes of live blocks;
  the port's are 0, so only hit lanes are compared;
- sky_rgb: within 1e-5 of max(|value|, 1), relatively: the port folds the
  daylight basis spectra into the CIE weights (lights/sunsky.py), which
  changes only the rounding (measured 2.7e-6); exactly 0 below the
  horizon;
- frames, with lucille_tpu's threefry jitter (test_torch_render.py's
  JaxSampler): pixel values are sky radiance in the thousands, so
  differences are relative: mean |diff| / mean <= 1e-4 and all but 1% of
  the pixels within 1e-4 of their value (a flipped stratum moves a pixel
  by ~1/16);
- the 80x60 frame against CPU-lucille's (tests/golden/sunsky_80x60_ref
  .hdr, made with the reference's turbidity-0 sun): the bounds
  tests/test_sunsky_golden.py holds lucille_tpu to: correlation > 0.995,
  channel ratios over hit pixels in (0.90, 1.05), mean relative error
  < 0.08.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_intersect import _random_soup, _scene_from_tris
from test_torch_render import JaxSampler
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import REPO, bundled_state, heightfield_state


def _grid_and_soup(n_soup, seed=5):
    """A 6x6 grid of unit squares in the plane y = -6 (two triangles each,
    sharing the diagonal and the square's edges) plus a random soup;
    lucille_tpu's dense scene of them, and shadow rays from above straight
    down onto 32 shared edges' midpoints."""
    xs, zs = np.meshgrid(np.arange(7.0) - 3, np.arange(7.0) - 3)
    P = np.stack([xs, np.full_like(xs, -6.0), zs], -1).reshape(-1, 3)
    a = (np.arange(6)[None, :] + 7 * np.arange(6)[:, None]).ravel()
    tri = np.concatenate([np.stack([a, a + 1, a + 8], -1),
                          np.stack([a, a + 8, a + 7], -1)])
    s0, s1, s2 = _random_soup(n_soup, seed=seed)
    v0 = np.concatenate([P[tri[:, 0]], s0])
    v1 = np.concatenate([P[tri[:, 1]], s1])
    v2 = np.concatenate([P[tri[:, 2]], s2])
    mids = np.concatenate([(P[a] + P[a + 8]) / 2,  # the diagonals
                           (P[a] + P[a + 1]) / 2])[:32]
    o = mids + np.array([0.0, 12.0, 0.0])
    d = np.tile([0.0, -1.0, 0.0], (32, 1))
    return _scene_from_tris(v0, v1, v2, "pallas"), o, d


def _shadow_rays(B, seed=2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (B, 3))
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


# 420 + 72 triangles -> 512 padded -> 4 tiles (lucille_tpu ignores the
# mask); 1100 + 72 -> 1280 -> 10 tiles (it compacts live rays)
@pytest.mark.parametrize("n_soup,n_tiles", [(420, 4), (1100, 10)])
@pytest.mark.parametrize("tmax", ["none", "scalar", "rows"])
@pytest.mark.parametrize("masked", [False, True])
def test_any_hit_twin_matches_pallas(n_soup, n_tiles, tmax, masked):
    from lucille_tpu.accel.pallas_isect import pallas_any_hit
    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.accel.dispatch import any_hit
    from lucille_tpu_torch.scene.types import from_numpy

    sc, o_edge, d_edge = _grid_and_soup(n_soup)
    assert -(-sc.tri_v0.shape[0] // 128) == n_tiles
    o, d = _shadow_rays(512 - 32)
    o = np.concatenate([o_edge, o]).astype(np.float32)
    d = np.concatenate([d_edge, d]).astype(np.float32)
    rng = np.random.default_rng(3)
    t_np = {"none": None, "scalar": np.float32(4.0),
            "rows": rng.uniform(0.5, 14, 512).astype(np.float32)}[tmax]
    t_np = t_np if tmax != "rows" else np.where(np.arange(512) < 32, 13.0,
                                                t_np).astype(np.float32)
    active = (rng.uniform(size=512) < 0.6) | (np.arange(512) < 32)
    ref = np.asarray(pallas_any_hit(
        sc, jnp.asarray(o), jnp.asarray(d),
        None if t_np is None else jnp.asarray(t_np),
        active=jnp.asarray(active) if masked else None, interpret=True))
    isect.ANY_COUNTS.reset()
    t_arg = None if t_np is None else torch.as_tensor(t_np)
    got = any_hit(from_numpy(sc, "cpu"), torch.from_numpy(o),
                  torch.from_numpy(d), t_arg,
                  torch.from_numpy(active) if masked else None)["occ"]
    got = got.numpy()
    assert (isect.ANY_COUNTS.kernel, isect.ANY_COUNTS.plain) == (0, 1)
    live = active if masked else np.ones(512, bool)
    np.testing.assert_array_equal(got[live], ref[live])
    assert not got[~live].any()
    if tmax != "scalar":  # the grid lies 12 below the edge rays' origins
        assert got[:32].all()
    assert 0.05 < ref[live].mean() < 0.95  # the case exercises both answers


def _lanes(B, seed=1):
    from lucille_tpu.transport.ao import ortho_basis

    rng = np.random.default_rng(seed)
    P = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    N = rng.normal(size=(B, 3))
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).astype(np.float32)
    b0, b1, b2 = (np.array(b) for b in ortho_basis(jnp.asarray(N)))
    return P, b0, b1, b2, rng.uniform(size=B) < 0.8


def _popcount(x):
    x = x.astype(np.uint32)
    return np.array([bin(int(v)).count("1") for v in x.ravel()]).reshape(
        x.shape)


# 400 -> 4 tiles (hit-first partition), 1100 -> 10 tiles (octant + Morton)
@pytest.mark.parametrize("n_tris", [400, 1100])
@pytest.mark.parametrize("ntheta", [4, 8])
def test_ao_bits_twin_matches_pallas(n_tris, ntheta):
    from lucille_tpu.accel.pallas_ao import pallas_ao_occlusion_bits
    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.scene.types import from_numpy

    v0, v1, v2 = _random_soup(n_tris, seed=5)
    sc = _scene_from_tris(v0, v1, v2, "pallas")
    B, S = 256, ntheta * ntheta
    P, b0, b1, b2, hit = _lanes(B)
    key = jax.random.key(7)
    occ_r, bits_r, u01_r = (np.asarray(x) for x in pallas_ao_occlusion_bits(
        sc, jnp.asarray(P), jnp.asarray(b0), jnp.asarray(b1),
        jnp.asarray(b2), jnp.asarray(hit), key, ntheta, ntheta,
        interpret=True))
    jitter = torch.from_numpy(
        np.array(jax.random.uniform(key, (2, B), dtype=jnp.float32)))
    ao.BITS_COUNTS.reset()
    t = torch.from_numpy
    occ, bits, u01 = (x.numpy() for x in ao.ao_occlusion_bits(
        from_numpy(sc, "cpu"), t(P), t(b0), t(b1), t(b2), t(hit), jitter,
        ntheta, ntheta))
    assert (ao.BITS_COUNTS.kernel, ao.BITS_COUNTS.plain) == (0, 1)
    assert bits.shape == bits_r.shape == (-(-S // 32), B)
    assert bits.dtype == np.int32
    np.testing.assert_array_equal(u01, u01_r)
    # the bits are the counts, lane for lane; misses are all 0
    np.testing.assert_array_equal(_popcount(bits).sum(axis=0), occ)
    assert not bits[:, ~hit].any()
    flips = _popcount(bits ^ bits_r).sum(axis=0)[hit]
    assert (flips != 0).mean() <= 0.01 and flips.max() <= 1
    assert np.abs(occ - occ_r).max() <= 1
    assert occ_r[hit].mean() > 0.5  # the case exercises occlusion


def test_stratum_directions_pair_with_the_bits():
    """The sunsky gather recomputes stratum s's direction with
    stratum_directions and trusts bit s for it: tracing each direction
    with the dense any-hit (Moller-Trumbore, not the gather's
    signed-volume test) gives the bits back but for grazing rays (<= 1%);
    pack_bits and unpack_bits are each other's inverse."""
    from lucille_tpu_torch.accel import ao, isect
    from lucille_tpu_torch.accel.pack import pack_occ
    from lucille_tpu_torch.scene.types import from_numpy

    v0, v1, v2 = _random_soup(400, seed=5)
    scene = from_numpy(_scene_from_tris(v0, v1, v2, "pallas"), "cpu")
    P, b0, b1, b2, _hit = (torch.from_numpy(np.asarray(a))
                           for a in _lanes(256))
    u01 = torch.rand((2, 256), generator=torch.Generator().manual_seed(1))
    rays = torch.cat([P, b0, b1, b2], dim=1).T.contiguous()
    _occ, bits = ao.ao_occlusion_reference(pack_occ(scene), rays, u01, 5, 7,
                                           want_bits=True)
    flags = ao.unpack_bits(bits, 35)
    assert bits.shape == (2, 256) and 0.05 < flags.float().mean() < 0.9
    d = ao.stratum_directions(b0, b1, b2, u01, 5, 7)
    traced = torch.stack([isect.any_hit(scene, P, d[s].contiguous())["occ"]
                          for s in range(35)])
    assert (traced != flags).float().mean() <= 0.01
    assert torch.equal(ao.pack_bits(flags), bits)
    assert torch.equal(ao.unpack_bits(ao.pack_bits(flags[:, :5]), 35),
                       flags[:, :5])


def _tile_gather(make_state, tile, seed=3):
    """The sunsky gather's inputs on the first tile of a frame rendered on
    the CPU: (scene, P_off, b0, b1, b2, hit, the tile stream's (2, B)
    draw, the scene's sky)."""
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.render.renderer import Renderer, tile_eye_rays
    from lucille_tpu_torch.render.tiles import tile_list
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples
    from lucille_tpu_torch.sampling.jitter import HostSampler
    from lucille_tpu_torch.transport.ao import shading_frame

    r = Renderer(make_state().scene, tile_size=tile, device="cpu",
                 sampler=HostSampler(seed, "cpu"))
    opt = r.desc.options
    xs, ys = (int(v) for v in opt.current_display().sampling_rates)
    sub = torch.tensor(subpixel_samples(xs, ys)[0], dtype=torch.float32)
    x0, y0, _i, _j = tile_list(opt.width, opt.height, tile,
                               opt.bucket_order)[0]
    org, dirn = tile_eye_rays(r.camera, x0, y0, tile, tile, sub)
    res = closest_hit(r.scene, org, dirn)
    P_off, b0, b1, b2 = shading_frame(r.scene, org, dirn, res)
    sky = next(li.sunsky for li in r.lights if li.type == "sunsky")
    return (r.scene, P_off, b0, b1, b2, res["hit"],
            r.sampler(x0, y0).uniform((), (2, org.shape[0])), sky)


# the bundled scene (4 triangle tiles: hit-first lane order) and the 35x35
# heightfield (20 tiles: octant + Morton order), at S = 64 and 42 (the
# second bits row part-filled)
@pytest.mark.parametrize("ntheta,nphi", [(8, 8), (6, 7)])
@pytest.mark.parametrize("scene", ["bundled", "heightfield35"])
def test_ao_sunsky_cpu_route_equals_the_bits_arithmetic(scene, ntheta, nphi):
    """accel/ao.ao_sunsky on CPU tensors (the gather's twin, then the
    sky's twin on the compacted hit lanes, scattered once) against the
    arithmetic the dense sunsky gather ran before the sky had its kernel:
    the bits and the jitter scattered to raster order, every stratum of
    every lane unpacked, its direction rebuilt, the sky along it in the
    z-up frame and the sum over the open strata of the hit lanes.  Every
    (lane, stratum) term is the same number, so the sum in stratum order
    (the twin's and the kernel's) is equal exactly; torch's `.sum(dim=0)`,
    which that arithmetic took, orders its terms by the tensor's layout
    (raster against compacted lanes), within S roundings of it."""
    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.lights.sunsky import sky_frame

    make = {"bundled": lambda: bundled_state(32, 24, pixelsamples=2,
                                             sunsky=True),
            "heightfield35": lambda: heightfield_state(
                35, 32, 32, pixelsamples=2, sunsky=True)}[scene]
    sc, P_off, b0, b1, b2, hit, jitter, sky = _tile_gather(make, 16)
    assert sc.boxes.shape[1] == (4 if scene == "bundled" else 20)
    ao.SKY_COUNTS.reset()
    got = ao.ao_sunsky(sc, P_off, b0, b1, b2, hit, jitter, ntheta, nphi, sky)
    assert (ao.SKY_COUNTS.kernel, ao.SKY_COUNTS.plain) == (0, 1)
    S = ntheta * nphi
    _occ, bits, u01 = ao.ao_occlusion_bits(sc, P_off, b0, b1, b2, hit, jitter,
                                           ntheta, nphi)
    vis = ~ao.unpack_bits(bits, S) & hit[None, :]
    d = ao.stratum_directions(b0, b1, b2, u01, ntheta, nphi)
    terms = vis[..., None] * sky.sky_rgb(sky_frame(d))  # (S, B, 3)
    assert got.shape == (hit.shape[0], 3) and got.dtype == torch.float32
    assert 0.2 < hit.float().mean() < 1.0 and not got[~hit].any()
    assert 0 < vis.float().mean() < hit.float().mean()  # some strata closed
    assert got[hit].min() > 100.0  # sky radiance in the thousands
    want = torch.zeros_like(got)
    for s in range(S):
        want = want + terms[s]
    assert torch.equal(got, want)
    old = terms.sum(dim=0)
    assert ((got - old).abs() <= S * 2.0**-24 * old).all()


def test_sky_params_follow_the_kernels_struct():
    """PreethamSunSky.kernel_params: each float the f32 rounding (as
    torch rounds a Python float against an f32 tensor) of the
    PreethamSunSky field that csrc/ao.cu's SkyParams holds at that place;
    as many as the struct holds, its SKY_NPARAMS, the count lt_sky_gather
    refuses anything else than, which it takes as an int after the
    params' pointer."""
    import ctypes
    import re

    from lucille_tpu_torch.kernels.build import CSRC, SIGNATURES
    from lucille_tpu_torch.lights.sunsky import (
        _XYZ2RGB_CIE,
        PreethamSunSky,
        _folded_basis,
    )

    sky = PreethamSunSky(turbidity=3.1, julian_day=200, hour=14.25)
    got = sky.kernel_params()
    assert got.dtype == np.float32 and got.shape == (40,)
    fields = {
        "sun": sky.sun_direction(), "Yz": [sky.Yz], "xz": [sky.xz],
        "yz": [sky.yz],
        "perez": [getattr(sky, c + k) for k in "Yxy" for c in "ABCDE"],
        "theta_s": [sky.theta_s],
        "basis": [v for row in _folded_basis() for v in row],
        "m": _XYZ2RGB_CIE.ravel(),
    }
    src = (CSRC / "ao.cu").read_text()
    body = re.search(r"struct SkyParams \{(.*?)\};", src, re.S).group(1)
    decls = re.findall(r"float ([^;]+);", body)
    order, sizes = [], {}
    for decl in decls:
        for name in (x.strip() for x in decl.split(",")):
            dims = [int(n) for n in re.findall(r"\[(\d+)\]", name)]
            name = name.split("[")[0]
            order.append(name)
            sizes[name] = int(np.prod(dims)) if dims else 1
    assert order == list(fields)
    want = []
    for name in order:
        assert len(fields[name]) == sizes[name], name
        want += [float(v) for v in fields[name]]
    assert len(want) == int(re.search(
        r"constexpr int SKY_NPARAMS = (\d+);", src).group(1))
    assert "nparams != SKY_NPARAMS" in src
    # each value rounds as torch rounds it in sky_rgb's arithmetic
    ref = (torch.ones(len(want)) * torch.tensor(want, dtype=torch.float64)
           .to(torch.float32)).numpy()
    np.testing.assert_array_equal(got, ref)
    one = torch.ones((), dtype=torch.float32)
    for i, v in enumerate(want):
        assert (one * v).item() == got[i]
    sig = SIGNATURES["lt_sky_gather"]
    assert len(sig) == 14 and sig[9] is ctypes.c_void_p
    assert sig[10] is ctypes.c_int


def test_glue_reader_counts_the_sky_kernel_as_hand_written():
    """The benchmark's trace reader takes csrc/*.cu's __global__ functions
    for the port's own kernels, so the sky's kernel is not glue."""
    import sys

    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        from harness.trace import hand_kernel_names, kernel_pattern
    finally:
        sys.path.remove(str(REPO / "benchmark"))

    names = hand_kernel_names(REPO / "lucille_tpu_torch")
    assert {"sky_gather_kernel", "ao_kernel"} <= names
    pat = kernel_pattern(names)
    assert pat.search("void (anonymous namespace)::sky_gather_kernel<false>"
                      "(float const*, float const*, int const*, int)")
    # the AO gather's roofline reads ao_kernel's time alone
    assert not kernel_pattern({"ao_kernel"}).search(
        "void (anonymous namespace)::sky_gather_kernel<false>(float const*)")


@pytest.mark.parametrize("turbidity", [2.2, 6.0])
def test_sky_rgb_close_to_jax(turbidity):
    from lucille_tpu.lights.sunsky import PreethamSunSky as JaxSky
    from lucille_tpu_torch.lights.sunsky import PreethamSunSky

    kw = dict(turbidity=turbidity, julian_day=172, hour=15.0)
    sky, ref_sky = PreethamSunSky(**kw), JaxSky(**kw)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(20000, 3))
    d[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    d[3] = sky.sun_direction()  # straight at the sun
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(ref_sky.sky_rgb(jnp.asarray(d)))
    got = sky.sky_rgb(torch.from_numpy(d)).numpy()
    assert got.dtype == np.float32 and got.shape == (20000, 3)
    below = d[:, 2] <= 0
    assert below.any() and not got[below].any()
    assert (got[~below] > 0).all() and want.max() > 1000
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= 1e-5


def _frame_pair(make_state, tile):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(make_state("jax").scene, tile_size=tile)
    ref = jr.render_frame()
    r = Renderer(make_state("torch").scene, tile_size=tile, device="cpu",
                 sampler=JaxSampler())
    return jr, r, ref, r.render_frame()


# the bundled scene as shipped: 4 triangle tiles (hit-first lane order) on
# the dense accel; 4 leaf tiles on the tile BVH (raster-lane jitter)
@pytest.mark.parametrize("accel", ["pallas", "bvh"])
def test_sunsky_frame_matches_jax(accel):
    from lucille_tpu_torch.accel import ao, bvh_isect, isect

    counts = (isect.COUNTS, isect.ANY_COUNTS, ao.COUNTS, ao.BITS_COUNTS,
              bvh_isect.CLOSEST_COUNTS, bvh_isect.ANY_COUNTS, ao.SKY_COUNTS)
    for c in counts:
        c.reset()
    jr, r, ref, got = _frame_pair(lambda pkg: bundled_state(
        32, 24, pixelsamples=1, gather=16, accel=accel, sunsky=True,
        pkg=pkg), 16)
    used = [c.plain > 0 for c in counts]
    assert used == ([True, True, False, True, False, False, True]
                    if accel == "pallas"
                    else [False, False, False, False, True, True, False])
    assert got.shape == ref.shape == (24, 32, 3) and np.isfinite(got).all()
    assert ref.mean() > 100.0  # sky radiance, not an AO fraction
    diff = np.abs(got - ref)
    assert diff.mean() / ref.mean() <= 1e-4
    assert (diff > 1e-4 * np.maximum(np.abs(ref), 1.0)).mean() <= 0.01
    # nrays: an eye ray per lane of the four full 16x16 tiles, S + 1 sun
    # ray per hit (ao.py:275-277); an eye ray may flip at a grazing edge
    assert (r.stats.nrays - 4 * 256) % 17 == 0 and r.stats.nrays > 4000
    assert abs(r.stats.nrays - jr.stats.nrays) <= 2 * 17


def test_sunsky_dense_morton_frame_agrees_with_jax():
    """The heightfield under the bundled scene's sunsky line: 20 triangle
    tiles, so the gather's lanes are in octant + Morton order, where an
    ulp in a shading point can hand a lane a neighbour's jitter
    (test_torch_render.py): the frames agree in their statistics, means
    over hit pixels within 0.5%."""
    _jr, _r, ref, got = _frame_pair(lambda pkg: heightfield_state(
        35, 32, 32, pixelsamples=1, gather=16, sunsky=True, pkg=pkg), 16)
    hit = (ref[..., 0] > 0) & (got[..., 0] > 0)
    assert hit.mean() > 0.2
    assert abs(got[hit].mean() / ref[hit].mean() - 1.0) <= 0.005


def test_matches_lucille_sunsky_golden_80x60():
    """The port against CPU-lucille's own sunsky-AO frame of the bundled
    scene (3x3 samples, 64 rays), with the reference's turbidity-0 sun
    (lucille_tpu/lights/sunsky.py:278-288)."""
    from lucille_tpu_torch.imageio.rgbe import read_hdr
    from lucille_tpu_torch.render.renderer import Renderer

    desc = bundled_state(80, 60, accel="auto", sunsky=True).scene
    sky = next(li.sunsky for li in desc.lights if li.type == "sunsky")
    for li in desc.lights:
        if li.type == "sun":
            li.color = sky.sunlight_rgb(turbidity=0.0)
    golden = read_hdr(REPO / "tests" / "golden" / "sunsky_80x60_ref.hdr")
    img = Renderer(desc, tile_size=32, device="cpu").render_frame()[::-1]
    gl, ml = golden.mean(-1), img.mean(-1)
    hit = ml > 0
    assert np.corrcoef(gl.ravel(), ml.ravel())[0, 1] > 0.995
    ratio = img[hit].mean(0) / golden[hit].mean(0)
    assert (ratio > 0.90).all() and (ratio < 1.05).all(), ratio
    rel = np.abs(ml - gl) / np.maximum(gl, 1.0)
    assert rel[hit].mean() < 0.08
