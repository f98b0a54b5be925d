"""Compile-time constants and canonical element-type schema.

Rebuild of the reference's schema layer:
  - size constants mirror the ``NinpolSizes`` enum
    (reference: ninpol/_interpolator/ninpol_defines.pxd:2-9)
  - element point/face/edge orderings mirror the YAML schema
    (reference: ninpol/utils/point_ordering.yaml:6-53), which follows the
    meshio cell-ordering convention (faces CCW / right-hand rule).

The orderings are expressed directly as Python data (instead of a YAML file
parsed at runtime) so that the padded lookup tables used by the jit-compiled
topology/geometry kernels are importable constants with static shapes.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Size constants (reference: ninpol_defines.pxd:2-9)
# ---------------------------------------------------------------------------
MAX_POINTS_PER_ELEMENT = 8
MAX_FACES_PER_ELEMENT = 6
MAX_POINTS_PER_FACE = 4
NUM_ELEMENT_TYPES = 8
MAX_EDGES_PER_ELEMENT = 12
MAX_ELEMENTS_PER_FACE = 2
MAX_POINTS_PER_EDGE = 2

DTYPE_I = np.int32   # all entity counts < 2^31; int64 doubled every
                     # topology array and the build-time page faults
DTYPE_F = np.float64

# ---------------------------------------------------------------------------
# Element-type schema (reference: point_ordering.yaml:6-53)
# type ids: vertex=0 line=1 triangle=2 quad=3 tetra=4 hexahedron=5 wedge=6
# pyramid=7
# ---------------------------------------------------------------------------
ELEMENT_SCHEMA = {
    "vertex": {
        "element_type": 0,
        "number_of_points": 1,
        "edges": [],
        "faces": [],
    },
    "line": {
        "element_type": 1,
        "number_of_points": 2,
        "edges": [[0, 1]],
        "faces": [],
    },
    "triangle": {
        "element_type": 2,
        "number_of_points": 3,
        "edges": [[0, 1], [1, 2], [2, 0]],
        "faces": [],
    },
    "quad": {
        "element_type": 3,
        "number_of_points": 4,
        "edges": [[0, 1], [1, 2], [2, 3], [3, 0]],
        "faces": [],
    },
    "tetra": {
        "element_type": 4,
        "number_of_points": 4,
        "edges": [[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]],
        "faces": [[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]],
    },
    "hexahedron": {
        "element_type": 5,
        "number_of_points": 8,
        "edges": [
            [0, 1], [1, 2], [2, 3], [3, 0],
            [4, 5], [5, 6], [6, 7], [7, 4],
            [0, 4], [1, 5], [2, 6], [3, 7],
        ],
        "faces": [
            [0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4],
            [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7],
        ],
    },
    "wedge": {
        "element_type": 6,
        "number_of_points": 6,
        "edges": [
            [0, 1], [1, 2], [2, 0],
            [3, 4], [4, 5], [5, 3],
            [0, 3], [1, 4], [2, 5],
        ],
        "faces": [
            [0, 2, 1], [3, 4, 5], [0, 1, 4, 3], [1, 2, 5, 4], [0, 3, 5, 2],
        ],
    },
    "pyramid": {
        "element_type": 7,
        "number_of_points": 5,
        "edges": [
            [0, 1], [1, 2], [2, 3], [3, 0],
            [0, 4], [1, 4], [2, 4], [3, 4],
        ],
        "faces": [[0, 3, 2, 1], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]],
    },
}

TYPE_NAME_TO_INDEX = {
    name: schema["element_type"] for name, schema in ELEMENT_SCHEMA.items()
}
TYPE_INDEX_TO_NAME = {v: k for k, v in TYPE_NAME_TO_INDEX.items()}

# Which element-type names belong to each spatial dimension
# (reference: interpolator.pyx:72-77).
TYPES_PER_DIMENSION = {
    0: ["vertex"],
    1: ["line"],
    2: ["triangle", "quad"],
    3: ["tetra", "hexahedron", "wedge", "pyramid"],
}


def build_type_tables(dim: int):
    """Build the padded per-element-type lookup tables for a mesh dimension.

    Mirrors the table extraction in the reference's ``process_mesh``
    (interpolator.pyx:300-331): for 2D meshes the *edges* of the schema act
    as the element "faces"; for 3D meshes the *faces* entry is used.

    Returns a dict of int64 arrays, all padded with -1:
      npoel (T,)        points per element type
      nfael (T,)        faces per element type
      lnofa (T, F)      points per face
      lpofa (T, F, P)   local point ids of each face
      nedel (T,)        edges per element type
      lpoed (T, E, 2)   local point ids of each edge
    """
    T = NUM_ELEMENT_TYPES
    npoel = np.full(T, -1, dtype=DTYPE_I)
    nfael = np.full(T, -1, dtype=DTYPE_I)
    lnofa = np.full((T, MAX_FACES_PER_ELEMENT), -1, dtype=DTYPE_I)
    lpofa = np.full((T, MAX_FACES_PER_ELEMENT, MAX_POINTS_PER_FACE), -1,
                    dtype=DTYPE_I)
    nedel = np.full(T, -1, dtype=DTYPE_I)
    lpoed = np.full((T, MAX_EDGES_PER_ELEMENT, MAX_POINTS_PER_EDGE), -1,
                    dtype=DTYPE_I)

    faces_key = "edges" if dim == 2 else "faces"

    for name, schema in ELEMENT_SCHEMA.items():
        t = schema["element_type"]
        npoel[t] = schema["number_of_points"]
        if name not in TYPES_PER_DIMENSION[dim]:
            continue

        faces = schema.get(faces_key, [])
        nfael[t] = len(faces)
        # Reference quirk (interpolator.pyx:317-323): lnofa/lpofa are only
        # filled when the schema has a "faces" entry, even in 2D where the
        # face list comes from "edges".  In 2D every relevant type has
        # faces == [] so the tables would stay -1; we instead fill them from
        # the selected face list, which is what the downstream topology code
        # actually requires, and matches 3D behavior exactly.
        for i, face in enumerate(faces):
            lnofa[t, i] = len(face)
            for j, p in enumerate(face):
                lpofa[t, i, j] = p

        edges = schema.get("edges", [])
        nedel[t] = len(edges)
        for i, edge in enumerate(edges):
            for j, p in enumerate(edge):
                lpoed[t, i, j] = p

    return {
        "npoel": npoel,
        "nfael": nfael,
        "lnofa": lnofa,
        "lpofa": lpofa,
        "nedel": nedel,
        "lpoed": lpoed,
    }
