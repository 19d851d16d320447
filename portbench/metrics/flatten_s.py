"""Host seconds of flattening the parsed scene into world-space tables in
set-up (`flatten`): the `scene.flatten` span. Nothing where the program
records no spans."""

from harness import spans


def read(ctx):
    return spans.setup_seconds(ctx, "scene.flatten")
