"""The plain reference: lucille's frame worked out again from the raw
scene, one module a render method (so far `ao`), each with
`render_pixels(scene, frame, frame_seed, pixels, device, dtype, cache)`.
"""

import importlib


def render_pixels(scene, frame, *args, **kwargs):
    """The frame's method's render_pixels."""
    mod = importlib.import_module(f"reference.{frame.method}")
    return mod.render_pixels(scene, frame, *args, **kwargs)
