"""Typed parameter store (counterpart of src/core/paramset.{h,cpp} ParamSet).

Declarations are `"type name" [ values ]`; supported types mirror the
reference: float, integer, string, bool, point/point3, point2, vector/vector3,
vector2, normal, rgb/color, xyz, blackbody, spectrum, texture.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpupt_torch.core.spectrum import blackbody_normalized, cie_xyz_fit, xyz_to_rgb

_SCALAR_TYPES = {"float", "integer", "bool", "string", "texture"}
_VEC3_TYPES = {"point", "point3", "vector", "vector3", "normal", "rgb", "color", "xyz"}
_VEC2_TYPES = {"point2", "vector2"}
KNOWN_TYPES = _SCALAR_TYPES | _VEC3_TYPES | _VEC2_TYPES | {"blackbody", "spectrum"}


class TextureRef(str):
    """A parameter value naming a texture (paramset.h texture params)."""


class ParamSet:
    def __init__(self):
        self._items: Dict[str, Tuple[str, Any]] = {}
        self._used: set = set()

    def add(self, decl: str, values: List):
        parts = decl.split()
        if len(parts) != 2:
            raise SyntaxError(f"malformed parameter declaration {decl!r}")
        ptype, name = parts
        if ptype not in KNOWN_TYPES:
            raise SyntaxError(f"unknown parameter type {ptype!r} in {decl!r}")
        self._items[name] = (ptype, self._convert(ptype, name, values))

    @staticmethod
    def _convert(ptype: str, name: str, values: List):
        if ptype == "string":
            return [str(v) for v in values]
        if ptype == "texture":
            return [TextureRef(v) for v in values]
        if ptype == "bool":
            return [v in ("true", True) for v in values]
        if ptype == "integer":
            return np.asarray(values, np.int64)
        if ptype == "float":
            return np.asarray(values, np.float64)
        if ptype in _VEC3_TYPES:
            arr = np.asarray(values, np.float64)
            if arr.size % 3:
                raise SyntaxError(f"parameter {name!r}: {arr.size} values not a multiple of 3")
            arr = arr.reshape(-1, 3)
            if ptype == "xyz":
                arr = np.stack([xyz_to_rgb(row) for row in arr])
            return arr
        if ptype in _VEC2_TYPES:
            arr = np.asarray(values, np.float64)
            if arr.size % 2:
                raise SyntaxError(f"parameter {name!r}: {arr.size} values not a multiple of 2")
            return arr.reshape(-1, 2)
        if ptype == "blackbody":
            # pairs (temperature K, scale) -> RGB (paramset.cpp AddBlackbodySpectrum)
            arr = np.asarray(values, np.float64).reshape(-1, 2)
            out = []
            lam = np.linspace(400.0, 700.0, 60)
            cx, cy, cz = cie_xyz_fit(lam)
            ynorm = cy.sum()
            for temp, scale in arr:
                s = blackbody_normalized(lam, temp)
                xyz = np.array([(s * cx).sum(), (s * cy).sum(), (s * cz).sum()]) / ynorm
                out.append(scale * xyz_to_rgb(xyz))
            return np.asarray(out)
        if ptype == "spectrum":
            if values and isinstance(values[0], str):
                warnings.warn(f"spectrum file {values[0]!r} not loaded; using 0.5 gray")
                return np.array([[0.5, 0.5, 0.5]])
            # (lambda, value) pairs -> RGB via CIE fit
            arr = np.asarray(values, np.float64).reshape(-1, 2)
            lam = np.linspace(400.0, 700.0, 60)
            s = np.interp(lam, arr[:, 0], arr[:, 1])
            cx, cy, cz = cie_xyz_fit(lam)
            xyz = np.array([(s * cx).sum(), (s * cy).sum(), (s * cz).sum()]) / cy.sum()
            return xyz_to_rgb(xyz)[None]
        raise AssertionError(ptype)

    # --- FindOne* accessors (paramset.h) ---

    def _find(self, name: str, types: set):
        if name in self._items and self._items[name][0] in types:
            self._used.add(name)
            return self._items[name][1]
        return None

    def find_one_float(self, name: str, default: float) -> float:
        v = self._find(name, {"float", "integer"})
        return float(v[0]) if v is not None and len(v) else default

    def find_one_int(self, name: str, default: int) -> int:
        v = self._find(name, {"integer", "float"})
        return int(v[0]) if v is not None and len(v) else default

    def find_one_bool(self, name: str, default: bool) -> bool:
        v = self._find(name, {"bool"})
        return bool(v[0]) if v else default

    def find_one_string(self, name: str, default: str) -> str:
        v = self._find(name, {"string"})
        return str(v[0]) if v else default

    def find_one_point(self, name: str, default) -> np.ndarray:
        v = self._find(name, _VEC3_TYPES)
        return np.asarray(v[0], np.float64) if v is not None and len(v) else np.asarray(default, np.float64)

    find_one_vector = find_one_point
    find_one_normal = find_one_point

    def find_one_spectrum(self, name: str, default) -> np.ndarray:
        """RGB value; texture refs are NOT returned here (see find_texture)."""
        v = self._find(name, {"rgb", "color", "xyz", "blackbody", "spectrum"})
        return np.asarray(v[0], np.float64) if v is not None and len(v) else np.asarray(default, np.float64)

    def find_texture(self, name: str) -> Optional[str]:
        v = self._find(name, {"texture"})
        return str(v[0]) if v else None

    def find_floats(self, name: str) -> Optional[np.ndarray]:
        v = self._find(name, {"float", "integer"})
        return None if v is None else np.asarray(v, np.float64)

    def find_ints(self, name: str) -> Optional[np.ndarray]:
        v = self._find(name, {"integer"})
        return None if v is None else np.asarray(v, np.int64)

    def find_points(self, name: str) -> Optional[np.ndarray]:
        v = self._find(name, _VEC3_TYPES)
        return None if v is None else np.asarray(v, np.float64)

    def find_point2s(self, name: str) -> Optional[np.ndarray]:
        v = self._find(name, _VEC2_TYPES)
        if v is not None:
            return np.asarray(v, np.float64)
        # the reference accepts plain float arrays for "float uv"
        return None

    def find_strings(self, name: str) -> Optional[List[str]]:
        v = self._find(name, {"string"})
        return None if v is None else [str(x) for x in v]

    def has(self, name: str) -> bool:
        return name in self._items

    def report_unused(self, context: str = ""):
        """Warn about parameters never read (paramset.cpp ReportUnused)."""
        for name in self._items:
            if name not in self._used:
                warnings.warn(f"{context}: unused parameter {name!r}")

    def __repr__(self):
        return f"ParamSet({list(self._items)})"
