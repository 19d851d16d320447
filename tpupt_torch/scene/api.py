"""Scene-description state machine (counterpart of src/core/api.{h,cpp}).

Consumes the directive stream from the parser and accumulates a
`SceneDescription`: shape records with baked current-transform-matrices,
graphics-state (material / area-light / reverse-orientation / medium)
attribute stacks (api.cpp:217,388), named coordinate systems, object
instancing with compose-on-top transforms (api.cpp:1752-1818), and the
render-options block (camera/film/sampler/integrator/accelerator).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpupt_torch.core.transforms import AnimatedTransform, Transform
from tpupt_torch.scene.params import ParamSet


@dataclass
class TextureDef:
    name: str
    kind: str  # "float" | "color"/"spectrum"
    klass: str  # "constant", "imagemap", "checkerboard", "scale", ...
    params: ParamSet
    tex2world: Transform


@dataclass
class MaterialSpec:
    type: str
    params: ParamSet


@dataclass
class MediumInterfaceSpec:
    inside: str = ""
    outside: str = ""


@dataclass
class GraphicsState:
    """Attribute-stack payload (api.cpp:388 GraphicsState)."""

    material: MaterialSpec = field(default_factory=lambda: MaterialSpec("matte", ParamSet()))
    area_light: Optional[Tuple[str, ParamSet]] = None
    reverse_orientation: bool = False
    medium_interface: MediumInterfaceSpec = field(default_factory=MediumInterfaceSpec)

    def copy(self) -> "GraphicsState":
        return GraphicsState(
            self.material, self.area_light, self.reverse_orientation,
            MediumInterfaceSpec(self.medium_interface.inside, self.medium_interface.outside),
        )


@dataclass
class ShapeRecord:
    type: str
    params: ParamSet
    object_to_world: Transform
    material: MaterialSpec
    area_light: Optional[Tuple[str, ParamSet]]
    reverse_orientation: bool
    medium_interface: MediumInterfaceSpec
    filename: str = ""
    # shutter-close transform when the CTM is animated (the reference wraps
    # such shapes in an animated TransformedPrimitive, api.cpp:1606);
    # None = static
    object_to_world_end: Optional[Transform] = None


@dataclass
class LightRecord:
    type: str
    params: ParamSet
    light_to_world: Transform
    medium: str = ""


@dataclass
class InstanceRecord:
    name: str
    instance_to_world: AnimatedTransform


@dataclass
class MediumRecord:
    name: str
    type: str
    params: ParamSet
    medium_to_world: Transform


@dataclass
class SceneDescription:
    """Everything pbrtWorldEnd would hand to MakeScene/MakeIntegrator."""

    shapes: List[ShapeRecord] = field(default_factory=list)
    lights: List[LightRecord] = field(default_factory=list)
    objects: Dict[str, List[ShapeRecord]] = field(default_factory=dict)
    instances: List[InstanceRecord] = field(default_factory=list)
    textures: Dict[str, TextureDef] = field(default_factory=dict)
    media: Dict[str, MediumRecord] = field(default_factory=dict)

    camera_name: str = "perspective"
    camera_params: ParamSet = field(default_factory=ParamSet)
    camera_to_world: AnimatedTransform = None  # type: ignore
    film_params: ParamSet = field(default_factory=ParamSet)
    filter_name: str = "box"
    filter_params: ParamSet = field(default_factory=ParamSet)
    sampler_name: str = "halton"
    sampler_params: ParamSet = field(default_factory=ParamSet)
    integrator_name: str = "path"
    integrator_params: ParamSet = field(default_factory=ParamSet)
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = field(default_factory=ParamSet)
    named_materials: Dict[str, "MaterialSpec"] = field(default_factory=dict)
    camera_medium: str = ""  # medium the camera sits in (MediumInterface)


_START, _END = 0, 1  # animated transform slots (MaxTransforms == 2)
_ALL = (True, True)


class SceneBuilder:
    """The pbrt* API surface as a class; one instance per parse."""

    def __init__(self):
        self.state = "options"  # Uninitialized->Options->World (api.cpp:382)
        self.ctm = [Transform(), Transform()]
        self.active = _ALL
        self.transform_stack: List[Tuple[List[Transform], Tuple[bool, bool]]] = []
        self.gs = GraphicsState()
        self.gs_stack: List[GraphicsState] = []
        self.coord_systems: Dict[str, List[Transform]] = {}
        self.current_object: Optional[str] = None
        self.transform_start_time = 0.0
        self.transform_end_time = 1.0
        self.out = SceneDescription()
        self.named_materials = self.out.named_materials

    # --- transform helpers ---

    def _for_active(self, t: Transform):
        for i in range(2):
            if self.active[i]:
                self.ctm[i] = self.ctm[i] * t

    # --- option-state directives ---

    def identity(self):
        for i in range(2):
            if self.active[i]:
                self.ctm[i] = Transform()

    def translate(self, x, y, z):
        self._for_active(Transform.translate([x, y, z]))

    def scale(self, x, y, z):
        self._for_active(Transform.scale([x, y, z]))

    def rotate(self, angle, x, y, z):
        self._for_active(Transform.rotate(angle, [x, y, z]))

    def look_at(self, ex, ey, ez, lx, ly, lz, ux, uy, uz):
        # LookAt directive composes world-to-camera (api.cpp pbrtLookAt)
        c2w = Transform.look_at([ex, ey, ez], [lx, ly, lz], [ux, uy, uz])
        self._for_active(c2w.inverse())

    def concat_transform(self, m16):
        m = np.asarray(m16, np.float64).reshape(4, 4).T  # column-major input
        self._for_active(Transform(m))

    def set_transform(self, m16):
        m = np.asarray(m16, np.float64).reshape(4, 4).T
        for i in range(2):
            if self.active[i]:
                self.ctm[i] = Transform(m)

    def coordinate_system(self, name):
        self.coord_systems[name] = [Transform(t.m) for t in self.ctm]

    def coord_sys_transform(self, name):
        if name in self.coord_systems:
            self.ctm = [Transform(t.m) for t in self.coord_systems[name]]
        else:
            warnings.warn(f"CoordSysTransform: unknown coordinate system {name!r}")

    def active_transform(self, which: str):
        self.active = {"StartTime": (True, False), "EndTime": (False, True),
                       "All": (True, True)}[which]

    def transform_times(self, start, end):
        self.transform_start_time = start
        self.transform_end_time = end

    def camera(self, name: str, params: ParamSet):
        self.out.camera_name = name
        self.out.camera_params = params
        # the camera lives in the CURRENT outside medium (api.cpp pbrtCamera
        # stores graphicsState.currentOutsideMedium as the camera medium)
        self.out.camera_medium = self.gs.medium_interface.outside
        w2c = [Transform(t.m) for t in self.ctm]
        self.out.camera_to_world = AnimatedTransform(
            w2c[0].inverse(), self.transform_start_time,
            w2c[1].inverse(), self.transform_end_time,
        )
        self.coord_systems["camera"] = [t.inverse() for t in w2c]

    def film(self, name: str, params: ParamSet):
        if name != "image":
            warnings.warn(f"Film type {name!r}; treating as 'image'")
        self.out.film_params = params

    def sampler(self, name: str, params: ParamSet):
        self.out.sampler_name = name
        self.out.sampler_params = params

    def integrator(self, name: str, params: ParamSet):
        self.out.integrator_name = name
        self.out.integrator_params = params

    def accelerator(self, name: str, params: ParamSet):
        self.out.accelerator_name = name
        self.out.accelerator_params = params

    def pixel_filter(self, name: str, params: ParamSet):
        self.out.filter_name = name
        self.out.filter_params = params

    def make_named_medium(self, name: str, params: ParamSet):
        mtype = params.find_one_string("type", "homogeneous")
        self.out.media[name] = MediumRecord(name, mtype, params, Transform(self.ctm[0].m))

    def medium_interface(self, inside: str, outside: str):
        self.gs.medium_interface = MediumInterfaceSpec(inside, outside)

    # --- world-state directives ---

    def world_begin(self):
        self.state = "world"
        self.ctm = [Transform(), Transform()]
        self.active = _ALL
        self.coord_systems["world"] = [Transform(), Transform()]

    def attribute_begin(self):
        self.gs_stack.append(self.gs.copy())
        self.transform_begin()

    def attribute_end(self):
        if not self.gs_stack:
            warnings.warn("AttributeEnd with empty stack")
            return
        self.gs = self.gs_stack.pop()
        self.transform_end()

    def transform_begin(self):
        self.transform_stack.append(([Transform(t.m) for t in self.ctm], self.active))

    def transform_end(self):
        if not self.transform_stack:
            warnings.warn("TransformEnd with empty stack")
            return
        self.ctm, self.active = self.transform_stack.pop()

    def reverse_orientation(self):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    def material(self, name: str, params: ParamSet):
        self.gs.material = MaterialSpec(name, params)

    def make_named_material(self, name: str, params: ParamSet):
        mtype = params.find_one_string("type", "matte")
        self.named_materials[name] = MaterialSpec(mtype, params)

    def named_material(self, name: str):
        if name in self.named_materials:
            self.gs.material = self.named_materials[name]
        else:
            warnings.warn(f"NamedMaterial: unknown material {name!r}")

    def texture(self, name: str, kind: str, klass: str, params: ParamSet):
        self.out.textures[name] = TextureDef(name, kind, klass, params, Transform(self.ctm[0].m))

    def area_light_source(self, name: str, params: ParamSet):
        self.gs.area_light = (name, params)

    def light_source(self, name: str, params: ParamSet):
        self.out.lights.append(
            LightRecord(name, params, Transform(self.ctm[0].m),
                        self.gs.medium_interface.outside)
        )

    def shape(self, name: str, params: ParamSet, filename: str = ""):
        import numpy as _np

        animated = not _np.allclose(self.ctm[0].m, self.ctm[1].m)
        rec = ShapeRecord(
            name, params, Transform(self.ctm[0].m), self.gs.material,
            self.gs.area_light, self.gs.reverse_orientation,
            MediumInterfaceSpec(self.gs.medium_interface.inside,
                                self.gs.medium_interface.outside),
            filename,
            object_to_world_end=(Transform(self.ctm[1].m) if animated
                                 else None),
        )
        if self.current_object is not None:
            self.out.objects[self.current_object].append(rec)
        else:
            self.out.shapes.append(rec)

    def object_begin(self, name: str):
        self.attribute_begin()
        if self.current_object is not None:
            warnings.warn("ObjectBegin inside instance definition")
        self.out.objects[name] = []
        self.current_object = name

    def object_end(self):
        self.current_object = None
        self.attribute_end()

    def object_instance(self, name: str):
        if name not in self.out.objects:
            warnings.warn(f"ObjectInstance: unknown object {name!r}")
            return
        # Instance transform composes ON TOP of the shape-definition CTM
        # (api.cpp:1778 ObjectInstance / TransformedPrimitive).
        self.out.instances.append(
            InstanceRecord(
                name,
                AnimatedTransform(
                    Transform(self.ctm[0].m), self.transform_start_time,
                    Transform(self.ctm[1].m), self.transform_end_time,
                ),
            )
        )

    def world_end(self) -> SceneDescription:
        if self.gs_stack or self.transform_stack:
            warnings.warn("WorldEnd: unmatched *Begin blocks")
        if self.out.camera_to_world is None:
            self.out.camera_to_world = AnimatedTransform(Transform(), 0.0, Transform(), 1.0)
        return self.out
