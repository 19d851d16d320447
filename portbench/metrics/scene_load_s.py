"""Host seconds of the scene front end (parse and flatten), from the
harness's span around the load."""


def read(ctx):
    return ctx["spans"].get("scene_load_s")
