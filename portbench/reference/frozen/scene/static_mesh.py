"""Array-backed static mesh.

The port's own copy of flexlight_tpu/scene/static_mesh.py (flexlight_tpu_torch imports
nothing of the JAX package).

A pre-baked scene-graph leaf produced by the native OBJ loader: it carries
its own flattened skip-list stream (geometry + attribute buffers + local
id buffer), exactly like a subtree baked with `Object3D.static = True`
(scene.js:841-864), so the flattener memcpys it in one shot. Material
setters broadcast over all triangles by writing the packed attribute rows
directly — no per-triangle Python objects exist at dragon scale.
"""

from __future__ import annotations

import numpy as np

from .primitives import ATTRIBUTE_FLOATS, GEOMETRY_FLOATS, KIND_BVH_NODE, KIND_TRIANGLE


class StaticMesh:
    indexable = False
    static = True

    def __init__(self, obj_data, materials: dict | None = None):
        t = obj_data.verts.shape[0]
        s = obj_data.kind.shape[0]
        self.length = t
        self.buffer_length = t
        self.texture_length = s
        self._transform = None
        self.static_permanent = False

        geometry = np.zeros((s, GEOMETRY_FLOATS), dtype=np.float32)
        attributes = np.zeros((s, ATTRIBUTE_FLOATS), dtype=np.float32)
        is_tri = obj_data.kind == 2
        is_node = obj_data.kind == 1
        tri_rows = np.where(is_tri)[0]
        tri_ids = obj_data.tri_index[tri_rows]

        geometry[is_node, 0:6] = obj_data.aabb[is_node]
        geometry[is_node, 6] = obj_data.skip[is_node]
        geometry[is_node, 10] = KIND_BVH_NODE
        geometry[tri_rows, 0:9] = obj_data.verts[tri_ids]
        geometry[tri_rows, 10] = KIND_TRIANGLE

        attributes[tri_rows, 0:9] = obj_data.normals[tri_ids]
        attributes[tri_rows, 9:15] = obj_data.uvs[tri_ids]
        attributes[tri_rows, 15:18] = -1.0
        # Material defaults (scene.js:620-623), then per-face MTL application
        # (scene.js:403-412)
        albedo = np.ones((t, 3), dtype=np.float32)
        rme = np.tile(np.array([1, 0, 0], dtype=np.float32), (t, 1))
        tpo = np.tile(np.array([0, 0, 1], dtype=np.float32), (t, 1))
        if materials:
            for mi, name in enumerate(obj_data.material_names):
                mat = materials.get(name)
                if mat is None:
                    continue
                sel = obj_data.mats[tri_ids] == mi
                albedo[sel] = np.asarray(mat.get("color", [255, 255, 255]),
                                         dtype=np.float32) / 255.0
                rme[sel] = [mat.get("roughness", 1), mat.get("metallicity", 0),
                            mat.get("emissiveness", 0)]
                tpo[sel] = [mat.get("translucency", 0), 0, mat.get("ior", 1)]
        attributes[tri_rows, 18:21] = albedo
        attributes[tri_rows, 21:24] = rme
        attributes[tri_rows, 24:27] = tpo

        self._geometry = geometry
        self._attributes = attributes
        self._tri_rows = tri_rows
        self.id_buffer = tri_rows.astype(np.int32)  # local slot offsets

    # --- flattener contract (scene.js:226-234) ---
    @property
    def geometry_buffer(self):
        return self._geometry.reshape(-1)

    @property
    def attribute_buffer(self):
        return self._attributes.reshape(-1)

    @property
    def min_max(self):
        v = self.vertices.reshape(-1, 3)
        return np.concatenate([v.min(axis=0), v.max(axis=0)])

    @property
    def vertices(self):
        return self._geometry[self._tri_rows, 0:9].reshape(-1)

    # --- material broadcast setters (Object3D parity) ---
    def _set_attr(self, cols, value):
        self._attributes[self._tri_rows, cols[0]:cols[1]] = value

    color = property(None, lambda self, c: self._set_attr(
        (18, 21), np.asarray(c, dtype=np.float32) / 255.0))
    albedo = property(None, lambda self, a: setattr(self, "color", a))
    roughness = property(None, lambda self, r: self._set_attr((21, 22), r))
    metallicity = property(None, lambda self, m: self._set_attr((22, 23), m))
    emissiveness = property(None, lambda self, e: self._set_attr((23, 24), e))
    translucency = property(None, lambda self, t: self._set_attr((24, 25), t))
    ior = property(None, lambda self, o: self._set_attr((26, 27), o))
    texture_nums = property(None, lambda self, tn: self._set_attr(
        (15, 18), np.asarray(tn, dtype=np.float32)))
    textureNums = texture_nums

    @property
    def transform(self):
        return self._transform

    @transform.setter
    def transform(self, t):
        self._transform = t
        self._geometry[:, 9] = 0 if t is None else t.number

    @property
    def transform_num(self):
        return 0 if self._transform is None else self._transform.number

    def move(self, x, y, z):
        """Translate verts + node AABBs (Object3D.move parity, scene.js:811)."""
        self.relative_position = [x, y, z]
        offset3 = np.array([x, y, z], dtype=np.float32)
        tri = self._geometry[self._tri_rows]
        tri[:, 0:9] += np.tile(offset3, 3)
        self._geometry[self._tri_rows] = tri
        node = self._geometry[:, 10] == KIND_BVH_NODE
        self._geometry[node, 0:3] += offset3
        self._geometry[node, 3:6] += offset3

    def scale(self, s):
        """Scale about relative_position (Object3D.scale parity, scene.js:831)."""
        pivot = np.asarray(getattr(self, "relative_position", [0, 0, 0]),
                           dtype=np.float32)
        tri = self._geometry[self._tri_rows]
        tri[:, 0:9] = ((tri[:, 0:9].reshape(-1, 3) - pivot) * s + pivot).reshape(-1, 9)
        self._geometry[self._tri_rows] = tri
        node = self._geometry[:, 10] == KIND_BVH_NODE
        self._geometry[node, 0:3] = (self._geometry[node, 0:3] - pivot) * s + pivot
        self._geometry[node, 3:6] = (self._geometry[node, 3:6] - pivot) * s + pivot
