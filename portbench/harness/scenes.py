"""Scene files of a configuration, made by the generator module its
`generator` names (`portbench/generators/<name>.py`) and kept in
`portbench/.cache/scenes/<config name>-<hash of the config>/`, a fixed
directory inside the checkout that git ignores. A later run of the same
configuration reads them from there."""

from __future__ import annotations

import hashlib
import importlib
import json
import os

from harness.manifest import HERE

CACHE = os.path.join(HERE, ".cache", "scenes")


def generator(config: dict):
    return importlib.import_module("generators." + config["generator"])


def _key(config: dict) -> str:
    digest = hashlib.sha1(json.dumps(config, sort_keys=True).encode())
    return f"{config['name']}-{digest.hexdigest()[:12]}"


def pbrt_file(config: dict, xres: int, yres: int) -> str:
    """Path of the configuration's .pbrt at this film size, its files
    written if the cache lacks them."""
    return generator(config).write_scene(
        config, xres, yres, os.path.join(CACHE, _key(config)))


def reference_scene(config: dict, xres: int, yres: int) -> dict:
    """The same scene as plain data, for the reference."""
    return generator(config).scene(config, xres, yres)
