"""Front end and compile: the seconds the port's own Timer entry "Scene
compile" gained over the Renderer's construction (render/renderer.py
times the displacement, the texture atlas and compile_arrays, the tile
BVH build among them, under that name)."""


def read(ctx):
    return ctx.compile_s
