"""The CUDA kernels against their plain torch twins, on the card.

These need a CUDA card (the kernels have no CPU mode) and skip without
one.  The file imports no jax, so it runs where jax is not installed; on
a machine with a card, from the repository root:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(--noconftest: tests/conftest.py sets up jax's CPU mesh for the other
tests.)  Tolerances: the kernels are built with --fmad=false and follow
their twins' operation order, so answers agree exactly except where the
kernels' conservative culls or the device's cos/sin round a boundary case
the other way: triangle ids on all but 1e-3 of the rays, t/u/v within
1e-6 relative, occlusion counts on all but 1e-3 of the lanes and within 1.
"""

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _soup_scene(n, seed=5):
    """n random triangles in a 10-unit box, as the dense scene on cuda."""
    from lucille_tpu.ri.types import AttributeState, GeomData, SceneDescription
    from lucille_tpu_torch.scene.compile import compile_scene

    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3))
    pos = np.concatenate([c + rng.normal(0, 0.3, (n, 3)) for _ in range(3)])
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1)
    desc = SceneDescription()
    desc.geoms.append(GeomData(positions=pos, indices=idx.astype(np.int32),
                               attrs=AttributeState()))
    desc.options.accel_method = "pallas"
    return compile_scene(desc, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1000, 4096])
def test_closest_hit_kernel_matches_plain(B):
    _need_card()
    from lucille_tpu_torch.accel.isect import (
        closest_hit_kernel,
        closest_hit_reference,
    )
    from lucille_tpu_torch.accel.pack import pack_boxes, pack_tris

    scene = _soup_scene(700)
    rng = np.random.default_rng(0)
    o = rng.normal(size=(B, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-4, 4, (B, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.tensor(o, dtype=torch.float32, device="cuda")
    d = torch.tensor(d, dtype=torch.float32, device="cuda")
    tris, boxes = pack_tris(scene), pack_boxes(scene)
    got = closest_hit_kernel(tris, boxes, o, d)
    ref = closest_hit_reference(tris, o, d)
    assert (got["tri"] >= 0).float().mean() > 0.2
    assert (got["tri"] != ref["tri"]).float().mean() <= 1e-3
    same = (got["tri"] == ref["tri"]) & (ref["tri"] >= 0)
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k][same], ref[k][same], rtol=1e-6,
                                   atol=1e-7)
    assert torch.all(torch.isinf(got["t"][got["tri"] < 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris,ntheta", [(400, 5), (1100, 4), (2500, 8)])
def test_ao_kernel_matches_plain(n_tris, ntheta):
    """Scenes below and above the Morton-order threshold and with 2
    supertiles; S = 25 is not a multiple of the kernel's 16-stratum chunk.
    Lanes at or past nact report 0."""
    _need_card()
    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.accel.pack import (
        pack_boxes,
        pack_occ,
        pack_super_boxes,
    )
    from lucille_tpu_torch.transport.ao import ortho_basis

    scene = _soup_scene(n_tris)
    rng = np.random.default_rng(1)
    P = torch.tensor(rng.uniform(-4, 4, (1000, 3)), dtype=torch.float32,
                     device="cuda")
    N = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(1000, 3)), dtype=torch.float32,
                     device="cuda"), dim=-1)
    b0, b1, b2 = ortho_basis(N)
    rays = torch.cat([P, b0, b1, b2], dim=1).T.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(2)
    u01 = torch.rand((2, 1000), device="cuda", generator=gen)
    tris, boxes = pack_occ(scene), pack_boxes(scene)
    nact = torch.tensor(900, dtype=torch.int32, device="cuda")
    got = ao.ao_occlusion_kernel(tris, boxes, pack_super_boxes(boxes), rays,
                                 u01, nact, ntheta, ntheta)
    ref = ao.ao_occlusion_reference(tris, rays[:, :900], u01[:, :900],
                                    ntheta, ntheta)
    assert torch.all(got[900:] == 0)
    assert ref.mean() > 1.0  # the case exercises occlusion
    diff = (got[:900] - ref).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3
