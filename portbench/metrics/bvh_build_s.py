"""Host seconds of the BVH build of set-up (`build_scene_bvh`: native
sweep-SAH, or the LBVH above its prim limit): the `upload.bvh` span.
Nothing where the program records no spans."""

from harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, "upload.bvh")
