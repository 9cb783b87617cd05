"""The port's parallel/ (mesh.py, distributed.py) and the Renderer's mesh
path, case for case against tests/test_parallel.py: meshes of CPU
replicas (`make_mesh(n, devices=["cpu"] * n)`, the counterpart of the
virtual 8-device pool) render the frame the Renderer renders without a
mesh, array for array, with the same counters, whatever the mesh's size
and however the tiles fall into rounds; the mesh frame meets
test_frame_matches_jax's bounds against lucille_tpu's sharded frame; and
two real processes joined by torch.distributed (gloo) through the CLI
render the one-process frame, --recover included, with rank 1 writing
no file.  Frames are 64x32 or 64x48 at tile 16, 4 gather rays."""

import os

import numpy as np
import pytest
import torch

# test_torch_scene puts the repo's root on sys.path, for chip_smoke
from test_torch_scene import bundled_rib_text
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_render import CASES, JaxSampler, check_frame_against_jax
from chip_smoke import DRYRUN_METHODS, cli_ranks, dryrun_state


def _tiny_scene(width=64, height=32):
    """tests/test_parallel.py's scene, through the port's front end."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib

    s = RiState()
    parse_rib(
        """
        Display "t.hdr" "file" "rgb"
        PixelSamples 1 1
        Projection "perspective" "fov" [45]
        Orientation "rh"
        ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -8 1]
        WorldBegin
        PointsPolygons [4] [0 1 2 3] "P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
        PointsPolygons [3] [0 1 2] "P" [-1 0 -1  1 0 -1  0 2 0]
        WorldEnd
        """,
        s,
    )
    s.Format(width, height)
    s.options.gather_nsamples = 4
    return s


def _cpu_mesh(n):
    from lucille_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=["cpu"] * n)


def _render(method, mesh=None, width=64, height=32, **render_kwargs):
    from lucille_tpu_torch.render.renderer import Renderer

    s = _tiny_scene(width, height)
    s.options.render_method = method
    s.options.max_ray_depth = 2
    r = Renderer(s.scene, tile_size=16, device="cpu",
                 mesh=_cpu_mesh(mesh) if mesh else None)
    return r.render_frame(**render_kwargs), r


class TestMesh:
    def test_make_mesh(self):
        mesh = _cpu_mesh(8)
        assert mesh.size == 8 and mesh.local
        assert mesh.owned == tuple(range(8))
        assert mesh.axis_names == ("tiles",)
        assert all(d == torch.device("cpu") for d in mesh.devices)

    def test_make_mesh_needs_the_cards(self, monkeypatch):
        """No fall-back to the CPU: the default devices are the cards, and
        a mesh of more than torch sees raises, naming the shortfall."""
        from lucille_tpu_torch.parallel.mesh import make_mesh

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh(2)
        with pytest.raises(ValueError, match="needs 3, have 2"):
            make_mesh(3, devices=["cpu"] * 2)

    def test_sharded_render_matches_single_device(self):
        from lucille_tpu_torch.parallel.mesh import render_frame_sharded

        s = _tiny_scene()
        img8, rays8 = render_frame_sharded(s.scene, _cpu_mesh(8), tile=16)
        s = _tiny_scene()
        img1, rays1 = render_frame_sharded(s.scene, _cpu_mesh(1), tile=16)
        # the same tile streams on any mesh size: the same frame
        np.testing.assert_array_equal(img8, img1)
        assert rays8 == rays1
        assert img8.shape == (32, 64, 3)
        assert img8.mean() > 0.01

    def test_uneven_tile_count(self):
        """64x48 at 16 px: 12 tiles over 8 slots, the second round short
        (its 4 empty slots render nothing and count nothing)."""
        img8, r8 = _render("ao", mesh=8, height=48)
        img0, r0 = _render("ao", height=48)
        assert img8.shape == (48, 64, 3)
        np.testing.assert_array_equal(img8, img0)
        assert (r8.stats.nrays, r8.stats.ntriangle_tests) == (
            r0.stats.nrays, r0.stats.ntriangle_tests) and r8.stats.nrays > 0


class TestUnifiedRenderer:
    """The mesh path is the Renderer's: the same tile function on every
    replica, so mesh and no-mesh frames are array-equal."""

    def test_ao_mesh_matches_single(self):
        img0, r0 = _render("ao")
        img8, r8 = _render("ao", mesh=8)
        np.testing.assert_array_equal(img0, img8)
        assert r0.stats.nrays == r8.stats.nrays
        assert len(r8.replicas) == 8 and r8.replicas[3].scene is not r8.scene

    def test_pathtrace_mesh_matches_single(self):
        img0, _ = _render("pathtrace")
        img8, _ = _render("pathtrace", mesh=8)
        np.testing.assert_array_equal(img0, img8)
        assert img8.mean() > 0.01

    def test_mesh_sizes_agree(self):
        img2, _ = _render("ao", mesh=2)
        img8, _ = _render("ao", mesh=8)
        np.testing.assert_array_equal(img2, img8)

    def test_checkpoint_resume_on_mesh(self, tmp_path):
        ckpt = str(tmp_path / "frame.ckpt.npz")
        img_full, _ = _render("ao", mesh=8)

        class Stop(Exception):
            pass

        count = [0]

        def bomb(x0, y0, t):
            count[0] += 1
            if count[0] == 3:
                raise Stop()

        with pytest.raises(Stop):
            _render("ao", mesh=8, tile_cb=bomb, checkpoint=ckpt)
        assert os.path.exists(ckpt)
        img_rec, r = _render("ao", mesh=8, checkpoint=ckpt, recover=True)
        np.testing.assert_array_equal(img_full, img_rec)
        assert not os.path.exists(ckpt)  # a completed frame removes it

    def test_distributed_single_process_noop(self):
        from lucille_tpu_torch.parallel.distributed import (
            all_gather_host,
            barrier,
            broadcast_from_primary,
            initialize_distributed,
            is_primary_host,
            process_count,
            process_index,
        )

        assert initialize_distributed() is False
        assert initialize_distributed(num_processes=1) is False
        assert initialize_distributed(process_id=1) is False
        assert (process_count(), process_index()) == (1, 0)
        assert is_primary_host()
        barrier()  # a no-op: must not hang
        tree = (np.arange(3), np.ones((2, 2)))
        assert broadcast_from_primary(tree) is tree
        got = all_gather_host((torch.arange(4), np.zeros((1, 2))))
        np.testing.assert_array_equal(got[0], np.arange(4))
        assert got[1].shape == (1, 2)
        with pytest.raises(ValueError, match="--coordinator"):
            initialize_distributed(num_processes=2)


@pytest.mark.parametrize("method", DRYRUN_METHODS)
def test_dryrun_integrators_on_mesh(method, tmp_path):
    """__graft_entry__.dryrun_multichip's four integrators on an 8-CPU
    mesh, each frame equal to the same Renderer's without a mesh (AO
    with a checker texture, Whitted with ks = kd = 0.5, the path tracer,
    the shader method's mirrormatte, whose trace() recurses)."""
    from lucille_tpu_torch.render.renderer import Renderer

    frames = []
    for mesh in (None, _cpu_mesh(8)):
        r = Renderer(dryrun_state(method, str(tmp_path)).scene, tile_size=16,
                     device="cpu", mesh=mesh)
        frames.append((r.render_frame(), r.stats.nrays))
    (img0, rays0), (img8, rays8) = frames
    assert img8.shape == (32, 64, 3) and rays8 == rays0 > 0
    np.testing.assert_array_equal(img8, img0)
    if method == "ao":
        assert r.textures.data is not None
        assert all(rep.textures.data.device == rep.device
                   for rep in r.replicas)


def test_mesh_frame_matches_jax():
    """The port's 8-CPU mesh frame (JaxSampler: lucille_tpu's tile keys)
    against lucille_tpu's Renderer on its 8-device virtual pool, under
    test_frame_matches_jax's bounds; 6 tiles over 8 slots, one short
    round on both sides."""
    from lucille_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    make_state, tile, _n = CASES["bundled"]
    jr = JaxRenderer(make_state("jax").scene, tile_size=tile,
                     mesh=jax_make_mesh(8))
    ref = jr.render_frame()
    desc = make_state("torch").scene
    pr = Renderer(desc, tile_size=tile, device="cpu", sampler=JaxSampler(),
                  mesh=_cpu_mesh(8))
    got = pr.render_frame()
    check_frame_against_jax("bundled", desc, jr, ref, pr, got)


# ---- two real processes on torch.distributed (gloo), through the CLI ----

# the CLI, printing the frame's nrays on every rank (its --stats prints
# on host 0 only)
CLI = ("import sys\n"
       "from lucille_tpu_torch.render.renderer import Renderer\n"
       "frame = Renderer.render_frame\n"
       "def counted(self, *a, **k):\n"
       "    out = frame(self, *a, **k)\n"
       "    print('NRAYS', self.stats.nrays, flush=True)\n"
       "    return out\n"
       "Renderer.render_frame = counted\n"
       "from lucille_tpu_torch.cli import main\n"
       "sys.exit(main(sys.argv[1:]))\n")
SMALL = ["--device", "cpu", "--width", "64", "--height", "32",
         "--pixelsamples", "1", "--gather-rays", "4", "--tile", "16"]
TIMEOUT = 120  # seconds the ranks may take


def _run_ranks(argvs):
    """The CLI printing its nrays once per argv, as the ranks of one gloo
    group (chip_smoke.cli_ranks); each rank's stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return cli_ranks(argvs, TIMEOUT, prefix=("-c", CLI), env=env)[0]


def _nrays(out: str) -> int:
    return int(next(line.split()[1] for line in out.splitlines()
                    if line.startswith("NRAYS")))


def _one_process(rib, out):
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.render.renderer import Renderer

    frame = Renderer.render_frame
    seen = []

    def counted(self, *a, **k):
        img = frame(self, *a, **k)
        seen.append(self.stats.nrays)
        return img

    Renderer.render_frame = counted
    try:
        assert main([rib, "-o", str(out), *SMALL]) == 0
    finally:
        Renderer.render_frame = frame
    return seen[0]


def test_two_processes_render_the_one_process_frame(tmp_path):
    rib = str(tmp_path / "scene.rib")
    (tmp_path / "scene.rib").write_text(bundled_rib_text())
    nrays = _one_process(rib, tmp_path / "one.hdr")
    outs = _run_ranks([[rib, "-o", str(tmp_path / f"rank{r}.hdr"), *SMALL]
                       for r in (0, 1)])
    assert (tmp_path / "rank0.hdr").read_bytes() == (
        tmp_path / "one.hdr").read_bytes()
    assert not (tmp_path / "rank1.hdr").exists()  # host 0 owns the displays
    assert [_nrays(o) for o in outs] == [nrays, nrays]


def test_two_processes_recover_from_host_0(tmp_path, monkeypatch):
    """Rank 0's checkpoint holds 3 of the 8 tiles and rank 1 has none at
    its own path: rank 0 broadcasts its state, both skip the same tiles
    (the real-process counterpart of test_parallel.TestDistributedRecover)
    and the frame equals the uninterrupted one."""
    from lucille_tpu_torch.cli import main
    from lucille_tpu_torch.display.drivers import FileDriver

    rib = str(tmp_path / "scene.rib")
    (tmp_path / "scene.rib").write_text(bundled_rib_text())
    nrays = _one_process(rib, tmp_path / "one.hdr")

    write = FileDriver.write
    n = [0]

    class Crash(Exception):
        pass

    def dying_write(self, x0, y0, tile):
        n[0] += 1
        if n[0] > 2:
            raise Crash
        write(self, x0, y0, tile)

    monkeypatch.setattr(FileDriver, "write", dying_write)
    with pytest.raises(Crash):
        main([rib, "-o", str(tmp_path / "rank0.hdr"), "--recover", *SMALL])
    monkeypatch.setattr(FileDriver, "write", write)
    ckpt = tmp_path / "rank0.hdr.ckpt.npz"
    with np.load(ckpt) as data:  # saved before the third tile's write
        assert int(data["done"].sum()) == 3 and data["done"].size == 8

    outs = _run_ranks([[rib, "-o", str(tmp_path / f"rank{r}.hdr"),
                        "--recover", *SMALL] for r in (0, 1)])
    assert (tmp_path / "rank0.hdr").read_bytes() == (
        tmp_path / "one.hdr").read_bytes()
    assert not (tmp_path / "rank1.hdr").exists()
    assert not ckpt.exists()  # the completed frame removes it
    got = [_nrays(o) for o in outs]
    assert got[0] == got[1] and 0 < got[0] < nrays
