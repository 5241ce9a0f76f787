"""The scene build in set-up (harness span ``scene.build``: mesh and sky
loading, the BVH build and packing, the tables, the copy to the card),
seconds."""


def read(ctx):
    return ctx.layer.get("scene.build_s")
