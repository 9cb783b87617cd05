"""The port runs without jax and without lucille_tpu, picks its device
explicitly, and launches no kernel on the CPU."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import REPO, bundled_rib_text, bundled_state

# jax, lucille_tpu, tools_tpu and bench_large blocked before the port is
# imported;
# if a startup hook preloaded one anyway, hold the modules the port's
# import added to the same rule
_SCRIPT = textwrap.dedent("""
    import sys
    before = {k for k, v in sys.modules.items() if v is not None}
    for blocked in ("jax", "lucille_tpu", "tools_tpu", "bench_large"):
        if blocked not in before:
            sys.modules[blocked] = None
    from lucille_tpu_torch.cli import main
    rc = main(sys.argv[1:])
    added = {k for k, v in sys.modules.items() if v is not None} - before
    bad = sorted(k for k in added if k.split(".")[0] in (
        "jax", "lucille_tpu", "tools_tpu", "bench_large"))
    assert not bad, bad
    import json
    from lucille_tpu_torch.accel import ao, bvh_ao, bvh_isect, isect
    counts = {name: (c.kernel, c.plain) for name, c in (
        ("closest_hit", isect.COUNTS), ("any_hit", isect.ANY_COUNTS),
        ("ao_occlusion", ao.COUNTS), ("ao_occlusion_bits", ao.BITS_COUNTS),
        ("bvh_closest_hit", bvh_isect.CLOSEST_COUNTS),
        ("bvh_any_hit", bvh_isect.ANY_COUNTS),
        ("bvh_ao_fused", bvh_ao.FUSED_COUNTS),
        ("sky_gather", ao.SKY_COUNTS))}
    print("NOJAX-OK", rc, len(added), json.dumps(counts))
""")


def _render_without_jax(tmp_path, rib_text, *argv, max_mean=1.0, env=None):
    """The CLI in a fresh interpreter where neither jax, lucille_tpu nor
    tools_tpu can be imported: (the image, {wrapper: (kernel launches,
    plain twin calls)}); the image's mean lies in (0, max_mean]."""
    from lucille_tpu.imageio.rgbe import read_hdr

    rib = tmp_path / "scene.rib"
    rib.write_text(rib_text)
    out = tmp_path / "out.hdr"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **(env or {}))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(rib), "-o", str(out),
         "--device", "cpu", "--width", "32", "--height", "24",
         "--pixelsamples", "1", "--gather-rays", "9", "--tile", "16",
         *argv],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(l for l in proc.stdout.splitlines()
                if l.startswith("NOJAX-OK 0 "))
    counts = json.loads(line.split(" ", 3)[3])
    counts = {k: tuple(v) for k, v in counts.items()}
    img = read_hdr(out)
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() <= max_mean
    return img, counts


def test_cli_renders_without_jax(tmp_path):
    _img, counts = _render_without_jax(tmp_path, bundled_rib_text())
    assert counts["closest_hit"][0] == counts["ao_occlusion"][0] == 0
    assert counts["closest_hit"][1] > 0 and counts["ao_occlusion"][1] > 0
    assert counts["bvh_closest_hit"] == counts["bvh_any_hit"] == (0, 0)
    assert counts["any_hit"] == counts["ao_occlusion_bits"] == (0, 0)


@pytest.mark.parametrize("accel", [[], ["--accel", "bvh"]])
def test_cli_renders_the_shipped_scene_without_jax(tmp_path, accel):
    """tests/golden/sunsky_scene.rib as shipped, its sunsky light
    included: the sunsky gather on the dense tiles (the closest hit, the
    AO gather with bits, the sky over its bits, the any-hit of the sun
    ray; not the plain gather) or on the tile BVH (both BVH twins), every
    one a twin."""
    img, counts = _render_without_jax(
        tmp_path, bundled_rib_text(sunsky=True), *accel, max_mean=1e5)
    assert img.mean() > 100.0  # sky radiance, not an AO fraction
    assert all(k == 0 for k, _p in counts.values())
    used = {name for name, (_k, p) in counts.items() if p}
    assert used == ({"bvh_closest_hit", "bvh_any_hit"} if accel else
                    {"closest_hit", "ao_occlusion_bits", "any_hit",
                     "sky_gather"})


def _heightfield_rib(n: int) -> str:
    """bench_large's heightfield terrain and camera (chip_smoke's copy) as
    RIB text: one PointsPolygons of (n - 1)^2 quads."""
    from chip_smoke import HEIGHTFIELD_CAMERA, heightfield_grid

    P, quads = heightfield_grid(n)
    fmt = lambda a: " ".join(f"{x:.9g}" for x in np.ravel(a))  # noqa: E731
    return (
        HEIGHTFIELD_CAMERA
        + "WorldBegin\n"
        f"PointsPolygons [{fmt(np.full(len(quads), 4))}] [{fmt(quads)}] "
        f'"P" [{fmt(P)}]\n'
        "WorldEnd\n"
    )


def test_cli_renders_a_pbvh_heightfield_without_jax(tmp_path):
    """--accel bvh puts a small heightfield (12^2 quads, 288 triangles) on
    the tile BVH: both BVH twins run, no dense wrapper, no kernel."""
    _img, counts = _render_without_jax(tmp_path, _heightfield_rib(13),
                                       "--accel", "bvh")
    assert counts["bvh_closest_hit"][0] == counts["bvh_any_hit"][0] == 0
    assert counts["bvh_closest_hit"][1] > 0 and counts["bvh_any_hit"][1] > 0
    assert counts["closest_hit"] == counts["ao_occlusion"] == (0, 0)
    assert counts["bvh_ao_fused"] == (0, 0)


def test_cli_renders_the_fused_gather_without_jax(tmp_path):
    """LUCILLE_BVH_AO=fused: the same heightfield's AO through the fused
    gather's twin (kernel 6's), not the cone gather's any-hit."""
    _img, counts = _render_without_jax(tmp_path, _heightfield_rib(13),
                                       "--accel", "bvh",
                                       env={"LUCILLE_BVH_AO": "fused"})
    assert counts["bvh_ao_fused"][0] == 0 and counts["bvh_ao_fused"][1] > 0
    assert counts["bvh_any_hit"] == (0, 0)
    assert counts["bvh_closest_hit"][1] > 0


@pytest.mark.parametrize("method", ["whitted", "pathtrace"])
def test_cli_renders_the_integrators_without_jax(tmp_path, method):
    """--method whitted and --method pathtrace on the bundled scene
    without its light (the default dome): Whitted gathers the dome
    through the dense AO gather's twin; the path tracer samples no light
    (escaped rays carry the dome) and bounces on the closest hit alone."""
    img, counts = _render_without_jax(tmp_path, bundled_rib_text(),
                                      "--method", method)
    assert all(k == 0 for k, _p in counts.values())
    used = {name for name, (_k, p) in counts.items() if p}
    assert used == ({"closest_hit", "ao_occlusion"} if method == "whitted"
                    else {"closest_hit"})
    assert img.mean() > 0.5  # the dome lights the scene


@pytest.mark.parametrize("accel", [[], ["--accel", "bvh"]])
def test_cli_renders_dirtmap_without_jax(tmp_path, accel):
    """--method dirtmap: the eye rays and every stratum's gather through
    the closest hit alone, bounded by the gather distance (the dense
    twin, or the tile BVH's), with jax and lucille_tpu blocked."""
    img, counts = _render_without_jax(tmp_path, bundled_rib_text(),
                                      "--method", "dirtmap", *accel)
    assert all(k == 0 for k, _p in counts.values())
    used = {name for name, (_k, p) in counts.items() if p}
    assert used == ({"bvh_closest_hit"} if accel else {"closest_hit"})
    # one call for the eye rays and one a stratum (9 gather rays: 3x3)
    name = "bvh_closest_hit" if accel else "closest_hit"
    assert counts[name][1] == 4 * (1 + 9)  # 4 tiles of 16 at 32x24
    assert img.mean() > 0.1


def test_port_scan_covers_the_shading_modules():
    """test_torch_frontend's AST scan walks every module of the package:
    the integrators and shading modules of this slice are among them."""
    files = {p.relative_to(REPO).as_posix()
             for p in (REPO / "lucille_tpu_torch").rglob("*.py")}
    assert {"lucille_tpu_torch/shading/reflection.py",
            "lucille_tpu_torch/lights/sampling.py",
            "lucille_tpu_torch/transport/common.py",
            "lucille_tpu_torch/transport/whitted.py",
            "lucille_tpu_torch/transport/pathtrace.py"} <= files


def test_port_scan_covers_this_slices_modules():
    """test_torch_frontend's AST scan walks every module of the package:
    the shell, the texture atlas, the two image codecs and the dirt map
    are among them."""
    files = {p.relative_to(REPO).as_posix()
             for p in (REPO / "lucille_tpu_torch").rglob("*.py")}
    assert {"lucille_tpu_torch/shell.py",
            "lucille_tpu_torch/texture/texture.py",
            "lucille_tpu_torch/imageio/exr.py",
            "lucille_tpu_torch/imageio/tex.py",
            "lucille_tpu_torch/transport/dirtmap.py"} <= files


@pytest.mark.parametrize("accel", [[], ["--accel", "bvh"]])
def test_cli_renders_an_ibl_scene_without_jax(tmp_path, accel):
    """A Whitted frame of the bundled scene under an importance-sampled
    IBL light (its map written by the port's codec, its table built on
    the device): the closest hit and the shadow rays' any-hit twins, on
    the dense tiles or the tile BVH, with jax, lucille_tpu and tools_tpu
    blocked."""
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    img = np.full((8, 16, 3), 0.5, np.float32)
    img[2, 5] = 400.0
    write_hdr(tmp_path / "sky.hdr", img)
    rib = bundled_rib_text().replace(
        "WorldBegin\n", 'WorldBegin\nLightSource "ibl" 1 "texture" '
        f'["{tmp_path / "sky.hdr"}"] "sampling" ["importance"]\n', 1)
    out, counts = _render_without_jax(tmp_path, rib, "--method", "whitted",
                                      "--maxraydepth", "2", *accel,
                                      max_mean=1e3)
    assert all(k == 0 for k, _p in counts.values())
    used = {name for name, (_k, p) in counts.items() if p}
    assert used == ({"bvh_closest_hit", "bvh_any_hit"} if accel else
                    {"closest_hit", "any_hit"})


def test_cli_renders_fog_and_an_imager_without_jax(tmp_path):
    """AO under fog with the background imager, with jax, lucille_tpu and
    tools_tpu blocked: the escaped pixels carry the imager's colour."""
    rib = bundled_rib_text().replace(
        "WorldBegin\n", 'Imager "background" "bgcolor" [0 0.5 0]\n'
        'WorldBegin\nAtmosphere "fog" "distance" [20.0]\n', 1)
    img, counts = _render_without_jax(tmp_path, rib)
    assert all(k == 0 for k, _p in counts.values())
    assert {n for n, (_k, p) in counts.items() if p} == {
        "closest_hit", "ao_occlusion"}
    assert ((img == np.float32([0, 0.5, 0])).all(-1)).mean() > 0.05


def test_port_scan_covers_the_environment_and_pipeline_modules():
    """test_torch_frontend's AST scan walks every module of the package:
    the environment maps, samplers, SIS, pipeline, Mie, noise and socket
    display modules are among them."""
    files = {p.relative_to(REPO).as_posix()
             for p in (REPO / "lucille_tpu_torch").rglob("*.py")}
    assert {f"lucille_tpu_torch/{m}.py" for m in (
        "lights/envmap", "lights/ibl", "lights/sisgen", "shading/pipeline",
        "ops/mie", "ops/noise", "display/sockdrv")} <= files


@pytest.mark.parametrize("accel", [[], ["--accel", "bvh"]])
def test_cli_renders_the_shader_method_without_jax(tmp_path, accel):
    """--method shader with a Surface compiled from an .sl on the search
    path (ambient, illuminance under the scene's sunsky and sun lights,
    a reflected trace()), with jax, lucille_tpu and tools_tpu blocked:
    the closest hit of every traced wavefront and the shadow rays'
    any-hit, each a twin."""
    (tmp_path / "nojaxglass.sl").write_text(
        "surface nojaxglass(float Kd = 0.6; float Kr = 0.3) {\n"
        "  normal Nn = faceforward(normalize(N), I);\n"
        "  illuminance(P, Nn, PI/2) { Ci += Kd * Cl * max(L . Nn, 0); }\n"
        "  Ci += Kr * trace(P, reflect(I, Nn));\n"
        "}\n")
    rib = bundled_rib_text(sunsky=True).replace(
        "WorldBegin\n", f'Option "searchpath" "shader" ["{tmp_path}"]\n'
        'WorldBegin\nSurface "nojaxglass"\n', 1)
    img, counts = _render_without_jax(tmp_path, rib, "--method", "shader",
                                      "--maxraydepth", "2", *accel,
                                      max_mean=1e5)
    assert all(k == 0 for k, _p in counts.values())
    used = {name for name, (_k, p) in counts.items() if p}
    assert used == ({"bvh_closest_hit", "bvh_any_hit"} if accel else
                    {"closest_hit", "any_hit"})
    # 4 tiles, each: the eye wavefront and 2 levels of trace()
    name = "bvh_closest_hit" if accel else "closest_hit"
    assert counts[name][1] == 4 * 3
    assert img.mean() > 1.0  # the sky through the reflections


def test_port_scan_covers_the_shader_modules():
    """test_torch_frontend's AST scan walks every module of the package:
    the shader system, the RSL compiler and the shader integrator are
    among them."""
    files = {p.relative_to(REPO).as_posix()
             for p in (REPO / "lucille_tpu_torch").rglob("*.py")}
    assert {f"lucille_tpu_torch/{m}.py" for m in (
        "shading/shader", "shading/sl", "transport/shaded")} <= files


def test_port_scan_covers_the_parallel_modules():
    """test_torch_frontend's AST scan walks every module of the package:
    parallel/ (the mesh, torch.distributed) is among them."""
    files = {p.relative_to(REPO).as_posix()
             for p in (REPO / "lucille_tpu_torch").rglob("*.py")}
    assert {f"lucille_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "distributed")} <= files


def test_cli_renders_a_mesh_without_jax(tmp_path):
    """--mesh 2 --device cpu (two CPU replicas) renders the frame without
    a mesh, where jax and lucille_tpu cannot be imported."""
    img, _ = _render_without_jax(tmp_path, bundled_rib_text())
    got, _ = _render_without_jax(tmp_path, bundled_rib_text(), "--mesh", "2")
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("argv", [["--mesh", "4"], ["--accel", "bruteforce"],
                                  ["--num-processes", "2"], ["--accel", "grid"],
                                  ["--coordinator", "localhost:1234"]])
def test_cli_refuses_unported_flags(argv, capsys, tmp_path, monkeypatch):
    """Nothing is refused as not ported any more: the multi-device flags
    are accepted, and where the run cannot go ahead the CLI exits naming
    what it lacks (--mesh 4 on cuda: the cards torch sees, held at none;
    --num-processes without --coordinator and the other way round); the
    accels bruteforce and grid, once refused here, render (--recover,
    --method dirtmap and shader: tests/test_torch_cli.py and
    test_cli_renders_the_shader_method_without_jax; --display socket:
    tests/test_torch_sockdrv.py)."""
    from lucille_tpu_torch.cli import main

    rib = tmp_path / "scene.rib"
    rib.write_text(bundled_rib_text())
    if argv[0] == "--accel":
        assert main([str(rib), *argv, "-o", str(tmp_path / "x.hdr"),
                     "--device", "cpu", "--width", "8", "--height", "6",
                     "--pixelsamples", "1", "--gather-rays", "4"]) == 0
        assert (tmp_path / "x.hdr").exists()
        assert "not ported" not in capsys.readouterr().err
        return
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as e:
        main([str(rib), *argv, "-o", str(tmp_path / "x.hdr")])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "not ported" not in err and "ROADMAP" not in err
    lacks = {"--mesh": "CUDA card", "--num-processes": "--coordinator",
             "--coordinator": "--num-processes"}[argv[0]]
    assert lacks in err
    assert not (tmp_path / "x.hdr").exists()


def test_cuda_without_card_raises():
    """Asking for cuda where there is none raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from lucille_tpu_torch.device import resolve_device
    from lucille_tpu_torch.render.renderer import Renderer

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(bundled_state(16, 16).scene, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_render_counts_no_launch():
    from lucille_tpu_torch.accel import ao, isect
    from lucille_tpu_torch.render.renderer import Renderer

    isect.COUNTS.reset()
    ao.COUNTS.reset()
    Renderer(bundled_state(16, 16, pixelsamples=1, gather=4).scene,
             tile_size=16, device="cpu").render_frame()
    assert (isect.COUNTS.kernel, ao.COUNTS.kernel) == (0, 0)
    assert (isect.COUNTS.plain, ao.COUNTS.plain) == (1, 1)
