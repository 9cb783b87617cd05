"""Interactive rendering shell.

Equivalent capability to lucille's readline REPL (src/lsh/lsh.c:55-61):
commands ``file/render/quit/nsamples/set/stat/maxdepth`` plus the view
navigation of the reference's testbed.  Invoked by `python -m
lucille_tpu_torch.cli` with no scene argument, or via `python -m
lucille_tpu_torch.shell [--device cpu]`.

The port's copy of lucille_tpu/shell.py: the same commands and code on
the port's RiState and Renderer, with these changes: the shell renders
on an explicit device (`Shell(device="cuda")`, the default, or "cpu").
"""

from __future__ import annotations

import math
import shlex
import sys

HELP = """commands:
  file <scene.rib>        load a RIB scene
  render [out.hdr]        render the loaded scene (to display or file)
  nsamples <n>            set AO/final-gather ray count
  maxdepth <n>            set maximum ray depth
  method <name>           ao | whitted | pathtrace | dirtmap | shader
  accel <name>            auto | pallas | bvh | grid | bruteforce | mxu
  format <w> <h>          set output resolution
  set <option> <value>    set a raw option field
  stat                    print render statistics
  matrix                  print the camera matrix
  view orbit <yaw> [pitch]   orbit the camera about the scene center (deg)
  view dolly <dist>          move along the view direction
  view pan <dx> <dy>         truck/pedestal in camera axes
  view save <file> | load <file>   save/restore the camera ('e'/'s')
  g                       render from the current view ('g' key,
                          src/testbed/README.txt)
  quit / exit             leave the shell
"""


class Shell:
    def __init__(self, device="cuda"):
        self.device = device
        self.state = None
        self.renderer = None
        self.path = None

    def cmd_file(self, path):
        from lucille_tpu_torch.ri.api import RiState
        from lucille_tpu_torch.rib.parser import parse_rib_file

        self.state = RiState()
        parse_rib_file(path, self.state)
        self.path = path
        self.renderer = None
        print(
            f"loaded {path}: {len(self.state.scene.geoms)} geoms, "
            f"{self.state.scene.ntriangles} triangles, "
            f"{len(self.state.scene.lights)} lights"
        )

    def cmd_render(self, out=None):
        if self.state is None:
            print("no scene loaded (use: file <scene.rib>)")
            return
        from lucille_tpu_torch.display.drivers import get_display_driver
        from lucille_tpu_torch.render.renderer import Renderer

        if self.renderer is None:
            self.renderer = Renderer(
                self.state.scene, tile_size=self.state.options.tile_size,
                device=self.device,
            )
        opt = self.state.options
        disp = opt.current_display()
        drv = get_display_driver("file" if out else disp.driver)
        drv.open(out or disp.name, opt.width, opt.height)
        self.renderer.render_frame(tile_cb=drv.write)
        drv.close()
        print(self.renderer.stats.report())

    # -- interactive viewpoint navigation (the testbed's orbit/render
    # loop, src/testbed/README.txt: 'g' render-from-view, 'e'/'s'
    # save/load view, simplerender.cpp) -------------------------------

    def _scene_center(self):
        import numpy as np

        if self.renderer is not None:
            sc = self.renderer.scene
            return 0.5 * (
                sc.bbox_min.cpu().numpy() + sc.bbox_max.cpu().numpy()
            )
        allv = [
            np.asarray(g.positions).reshape(-1, 3)
            for g in self.state.scene.geoms
        ]
        if allv:
            v = np.concatenate(allv)
            return 0.5 * (v.min(axis=0) + v.max(axis=0))
        return np.zeros(3)

    def cmd_view(self, *args):
        import numpy as np

        if self.state is None:
            print("no scene loaded")
            return
        cam = self.state.camera
        c2w = np.asarray(cam.camera_to_world, dtype=np.float64).copy()
        sub = args[0] if args else "show"
        if sub == "orbit":
            yaw = math.radians(float(args[1]))
            pitch = math.radians(float(args[2])) if len(args) > 2 else 0.0
            target = self._scene_center()
            eye = c2w[3, :3].copy()
            # rotate the eye (and the frame) about the target: yaw around
            # world y, pitch around the camera's right axis
            def rot(axis, ang):
                axis = axis / max(np.linalg.norm(axis), 1e-20)
                x, y, z = axis
                c, s = math.cos(ang), math.sin(ang)
                C = 1 - c
                return np.array([
                    [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
                    [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
                    [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
                ])
            R = rot(np.array([0.0, 1.0, 0.0]), yaw)
            if pitch:
                R = rot(c2w[0, :3], pitch) @ R
            # row-vector convention: frame rows transform by right-mult
            c2w[3, :3] = (eye - target) @ R.T + target
            c2w[0:3, :3] = c2w[0:3, :3] @ R.T
        elif sub == "dolly":
            d = float(args[1])
            fwd = c2w[2, :3] / max(np.linalg.norm(c2w[2, :3]), 1e-20)
            c2w[3, :3] += d * fwd
        elif sub == "pan":
            dx, dy = float(args[1]), float(args[2])
            right = c2w[0, :3] / max(np.linalg.norm(c2w[0, :3]), 1e-20)
            up = c2w[1, :3] / max(np.linalg.norm(c2w[1, :3]), 1e-20)
            c2w[3, :3] += dx * right + dy * up
        elif sub == "save":
            np.save(args[1] if args[1].endswith(".npy") else args[1] + ".npy",
                    c2w)
            print(f"view saved to {args[1]}")
            return
        elif sub == "load":
            path = args[1] if args[1].endswith(".npy") else args[1] + ".npy"
            c2w = np.load(path)
            print(f"view loaded from {path}")
        elif sub == "show":
            print(c2w)
            return
        else:
            print(f"unknown view subcommand '{sub}'")
            return
        cam.camera_to_world = c2w
        # camera is baked into the compiled tile kernel: rebuild
        self.renderer = None

    def cmd_stat(self):
        if self.renderer is not None:
            print(self.renderer.stats.report())
        from lucille_tpu_torch.base.timer import get_timer

        print(get_timer().dump())

    def cmd_matrix(self):
        if self.state is None:
            print("no scene loaded")
            return
        print("world_to_camera:\n", self.state.world_to_camera)
        print("camera_to_world:\n", self.state.camera.camera_to_world)

    def one(self, line: str) -> bool:
        """Execute one command; returns False to quit."""
        try:
            parts = shlex.split(line)
        except ValueError as e:
            print(f"parse error: {e}")
            return True
        if not parts:
            return True
        cmd, args = parts[0], parts[1:]
        try:
            if cmd in ("quit", "exit", "q"):
                return False
            elif cmd in ("help", "?"):
                print(HELP)
            elif cmd == "file":
                self.cmd_file(args[0])
            elif cmd == "render":
                self.cmd_render(args[0] if args else None)
            elif cmd == "view":
                self.cmd_view(*args)
            elif cmd == "g":  # testbed 'g': render from current view
                self.cmd_render(args[0] if args else None)
            elif cmd == "nsamples":
                self.state.options.gather_nsamples = int(args[0])
                self.renderer = None
            elif cmd == "maxdepth":
                self.state.options.max_ray_depth = int(args[0])
                self.renderer = None
            elif cmd == "method":
                self.state.options.render_method = args[0]
                self.renderer = None
            elif cmd == "accel":
                self.state.options.accel_method = args[0]
                self.renderer = None
            elif cmd == "format":
                self.state.Format(int(args[0]), int(args[1]))
                self.renderer = None
            elif cmd == "set":
                setattr(self.state.options, args[0], _parse_value(args[1]))
                self.renderer = None
            elif cmd == "stat":
                self.cmd_stat()
            elif cmd == "matrix":
                self.cmd_matrix()
            else:
                print(f"unknown command: {cmd} (try 'help')")
        except (IndexError, AttributeError) as e:
            print(f"usage error: {e} (try 'help')")
        except (FileNotFoundError, NotImplementedError) as e:
            print(e)
        return True

    def run(self):
        print("lucille_tpu_torch interactive shell — 'help' for commands")
        try:
            import readline  # noqa: F401 — line editing, like lsh.c
        except ImportError:
            pass
        while True:
            try:
                line = input("lsh> ")
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not self.one(line):
                break


def _parse_value(s: str):
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="lucille-tpu-torch-shell")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    Shell(device=p.parse_args(argv).device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
