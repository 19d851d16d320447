"""Host seconds of cutting the wide BVH into treelets in set-up
(`build_treelets`, two-level tables only): the `upload.treelets` span.
Nothing where the program records no spans or the tables are
single-level."""

from harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, "upload.treelets")
