"""Render statistics: ray counts, intersection-test counts, throughput.

Equivalent capability to lucille's ``ri_statistic_t`` + report
(src/render/render.h:40-47, src/render/raytrace.c:71-112): totals for rays
traced, triangle tests, and accel-structure traversal steps, plus the
derived **M rays/sec** headline metric.

The counters are not globals incremented from the hot loop: each tile's
integrator returns them as device tensors, the renderer pulls them with
the tile's image and accumulates them here once a frame.

The port's copy of lucille_tpu/base/stats.py, without its unread
`extra` field.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RenderStats:
    nrays: int = 0
    ntriangle_tests: int = 0
    ntraversals: int = 0
    render_seconds: float = 0.0

    def add(self, nrays: int = 0, ntriangle_tests: int = 0, ntraversals: int = 0):
        self.nrays += int(nrays)
        self.ntriangle_tests += int(ntriangle_tests)
        self.ntraversals += int(ntraversals)

    @property
    def mrays_per_sec(self) -> float:
        if self.render_seconds <= 0.0:
            return 0.0
        return self.nrays / self.render_seconds / 1.0e6

    def report(self) -> str:
        """Text report mirroring ri_raytrace_statistics (raytrace.c:71-112)."""
        lines = [
            "/= Raytracing statistics =================================",
            f"| Total rays                  :   {self.nrays:d}",
            f"| Total triangle tests        :   {self.ntriangle_tests:d}",
            f"| Total traversal steps       :   {self.ntraversals:d}",
        ]
        if self.nrays > 0:
            lines += [
                f"| triangle tests / ray        :   {self.ntriangle_tests / self.nrays:.2f}",
                f"| traversal steps / ray       :   {self.ntraversals / self.nrays:.2f}",
            ]
        lines += [
            f"| Render time                 :   {self.render_seconds:.3f} sec",
            f"| Mrays/sec                   :   {self.mrays_per_sec:.3f}",
            "\\=========================================================",
        ]
        return "\n".join(lines)
