"""The port runs without jax, picks its device explicitly, and launches
no kernel on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_scene import REPO, bundled_rib_text, bundled_state

# jax blocked before the port is imported; if a startup hook preloaded it
# anyway, hold the modules the port's import added to the same rule
_SCRIPT = textwrap.dedent("""
    import sys
    before = {k for k, v in sys.modules.items() if v is not None}
    if "jax" not in before:
        sys.modules["jax"] = None
    from lucille_tpu_torch.cli import main
    rc = main(sys.argv[1:])
    added = {k for k, v in sys.modules.items() if v is not None} - before
    bad = sorted(k for k in added if k == "jax" or k.startswith("jax."))
    assert not bad, bad
    from lucille_tpu_torch.accel import ao, isect
    assert isect.COUNTS.kernel == 0 and ao.COUNTS.kernel == 0
    assert isect.COUNTS.plain > 0 and ao.COUNTS.plain > 0
    print("NOJAX-OK", rc, len(added))
""")


def test_cli_renders_without_jax(tmp_path):
    from lucille_tpu.imageio.rgbe import read_hdr

    rib = tmp_path / "ao.rib"
    rib.write_text(bundled_rib_text())
    out = tmp_path / "ao.hdr"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(rib), "-o", str(out),
         "--device", "cpu", "--width", "32", "--height", "24",
         "--pixelsamples", "1", "--gather-rays", "9", "--tile", "16"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX-OK 0" in proc.stdout
    img = read_hdr(out)
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() < 1.0


@pytest.mark.parametrize("argv", [["--mesh", "4"], ["--recover"],
                                  ["--method", "whitted"], ["--accel", "bvh"],
                                  ["--coordinator", "localhost:1234"]])
def test_cli_refuses_unported_flags(argv, capsys):
    from lucille_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["scene.rib", *argv])
    assert e.value.code != 0
    assert "not ported" in capsys.readouterr().err


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
