"""Host seconds of building the tables and uploading them
(`Renderer.upload_seconds`: the BVH, the treelets where the tables are
two-level, the row packing and the copy to the device)."""


def read(ctx):
    return ctx["spans"].get("upload_s")
