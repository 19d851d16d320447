"""Scene-dump modes: --cat / --toply (pbrt.cpp:66-68,120-123).

`cat_scene` re-emits the PARSED SceneDescription as canonical pbrt
statements (the reference's --cat prints the statements as the parser
executes them, api.cpp printf paths); `--toply` additionally swaps every
inline trianglemesh for a binary PLY sidecar file referenced by a
`plymesh` statement, which is the reference's recipe for shrinking huge
ascii scenes. The PyTorch package's copy of the JAX package's
tools/catscene.py (numpy only): same text, byte-equal sidecars."""

from __future__ import annotations

import os

import numpy as np


def _fmt_vals(ptype, vals):
    out = []
    for v in vals:
        if ptype in ("string", "texture"):
            out.append(f'"{getattr(v, "name", v)}"')
        elif ptype == "bool":
            out.append('"true"' if v else '"false"')
        elif ptype == "integer":
            out.append(str(int(v)))
        else:
            out.append(f"{float(v):.9g}")
    return " ".join(out)


def _fmt_params(ps, skip=()):
    parts = []
    for name, (ptype, vals) in sorted(getattr(ps, "_items", {}).items()):
        if name in skip:
            continue
        flat = np.asarray(vals).reshape(-1) if ptype not in (
            "string", "texture", "bool") else vals
        parts.append(f'"{ptype} {name}" [ {_fmt_vals(ptype, flat)} ]')
    return " ".join(parts)


def _fmt_transform(xf):
    m = np.asarray(getattr(xf, "m", xf), np.float64).reshape(4, 4)
    if np.allclose(m, np.eye(4)):
        return None
    cols = m.T.reshape(-1)  # pbrt Transform takes column-major 16 floats
    return "Transform [ " + " ".join(f"{v:.9g}" for v in cols) + " ]"


def cat_scene(desc, out, to_ply: bool = False, ply_dir: str = "."):
    """Write the parsed scene back as pbrt statements to the stream `out`.
    to_ply converts inline trianglemeshes to binary .ply sidecars."""
    w = out.write
    ct = _fmt_transform(np.linalg.inv(
        np.asarray(desc.camera_to_world.start.m)
        if hasattr(desc.camera_to_world, "start")
        else np.asarray(desc.camera_to_world.m)))
    if ct:
        w(ct + "\n")
    w(f'Camera "{desc.camera_name}" {_fmt_params(desc.camera_params)}\n')
    w(f'Film "image" {_fmt_params(desc.film_params)}\n')
    w(f'PixelFilter "{desc.filter_name}" {_fmt_params(desc.filter_params)}\n')
    w(f'Sampler "{desc.sampler_name}" {_fmt_params(desc.sampler_params)}\n')
    w(f'Integrator "{desc.integrator_name}" '
      f'{_fmt_params(desc.integrator_params)}\n')
    w(f'Accelerator "{desc.accelerator_name}" '
      f'{_fmt_params(desc.accelerator_params)}\n')
    w("WorldBegin\n")
    for name, tex in desc.textures.items():
        w(f'Texture "{name}" "{tex.kind}" "{tex.klass}" '
          f'{_fmt_params(tex.params)}\n')
    for name, med in desc.media.items():
        w(f'MakeNamedMedium "{name}" "string type" [ "{med.type}" ] '
          f'{_fmt_params(med.params)}\n')
    for li in desc.lights:
        w("AttributeBegin\n")
        t = _fmt_transform(li.light_to_world)
        if t:
            w("  " + t + "\n")
        w(f'  LightSource "{li.type}" {_fmt_params(li.params)}\n')
        w("AttributeEnd\n")
    n_ply = 0
    for sh in desc.shapes:
        w("AttributeBegin\n")
        t = _fmt_transform(sh.object_to_world)
        if t:
            w("  " + t + "\n")
        if sh.reverse_orientation:
            w("  ReverseOrientation\n")
        if sh.medium_interface.inside or sh.medium_interface.outside:
            w(f'  MediumInterface "{sh.medium_interface.inside}" '
              f'"{sh.medium_interface.outside}"\n')
        if sh.area_light is not None:
            al_name, al_ps = sh.area_light
            w(f'  AreaLightSource "{al_name}" {_fmt_params(al_ps)}\n')
        w(f'  Material "{sh.material.type}" '
          f'{_fmt_params(sh.material.params)}\n')
        if to_ply and sh.type == "trianglemesh":
            from tpupt_torch.scene.plyio import write_ply

            P = np.asarray(sh.params.find_points("P"), np.float32)
            idx = np.asarray(sh.params.find_ints("indices"),
                             np.int32).reshape(-1, 3)
            N = sh.params.find_points("N")
            fn = f"mesh_{n_ply:05d}.ply"
            n_ply += 1
            path = os.path.join(ply_dir, fn)
            if os.path.exists(path):
                raise FileExistsError(
                    f"refusing to overwrite {path} (pass a clean ply_dir)")
            write_ply(path, P.reshape(-1, 3), idx,
                      N=(np.asarray(N, np.float32).reshape(-1, 3)
                         if N is not None and len(N) else None))
            w(f'  Shape "plymesh" "string filename" [ "{fn}" ]\n')
        else:
            w(f'  Shape "{sh.type}" {_fmt_params(sh.params)}\n')
        w("AttributeEnd\n")
    w("WorldEnd\n")
    return n_ply
