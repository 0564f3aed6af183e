"""Link geometry utilities: mesh loading and bounding boxes.

The port's own copy of flobaroid_tpu/models/geometry.py (numpy only):
the mesh readers (vertex clouds and triangle soups, STL and DAE) and
`link_bounding_box`.

Replaces the reference's trimesh dependency for the COM-hull SDP
constraints (identification/sdp.py:222-250 via
helpers.URDFHelpers.getBoundingBox) and for capsule fitting
(excitation/capsule.py:30-275): a self-contained binary/ASCII STL
reader plus URDF-geometry bounding boxes.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .urdf import RobotTree, rpy_to_matrix


def load_stl_vertices(path: str) -> np.ndarray:
    """Read an STL file (binary or ASCII) and return (V, 3) vertices."""
    with open(path, "rb") as f:
        head = f.read(84)
        if len(head) < 84:
            raise ValueError(f"not a valid STL file: {path}")
        # heuristic: binary STL has tri-count matching the file size
        (n_tri,) = struct.unpack("<I", head[80:84])
        size = os.path.getsize(path)
        if size == 84 + n_tri * 50:
            data = np.fromfile(f, dtype=np.uint8, count=n_tri * 50)
            rec = data.reshape(n_tri, 50)
            tri = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
            return tri.reshape(-1, 3).astype(float)
    # ASCII fallback
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        raise ValueError(f"could not parse STL: {path}")
    return np.asarray(verts)


def load_stl_triangles(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an STL file and return (vertices (V,3), triangles (T,3)).

    STL is a triangle soup, so vertices arrive in facet triplets; the
    index array is simply [[0,1,2],[3,4,5],...]. Consumers that need a
    welded mesh can np.unique the vertices — the distance queries
    (native_meshdist) work on the soup directly."""
    v = load_stl_vertices(path)
    n = (len(v) // 3) * 3
    v = v[:n]
    tris = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return v, tris


def load_dae_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a Collada (.dae) file and return (vertices (V,3),
    triangles (T,3)). The reference loads DAE via trimesh/pycollada
    (identification/collision.py:19-130, visualizer meshes); this is a
    self-contained XML reader covering the subset robot description
    packages use: <geometry>/<mesh> with <triangles> or <polylist>
    primitives, POSITION sources, the <unit meter=...> scale and the
    <up_axis> convention (Y_UP assets are rotated into the URDF's
    Z-up frame). Node/scene transforms are ignored (robot meshes put
    geometry in the file frame; URDF supplies the placement)."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    root = tree.getroot()
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]

    def findall(el, tag):
        return el.iter(ns + tag)

    unit = 1.0
    up = "Z_UP"
    asset = root.find(ns + "asset")
    if asset is not None:
        u = asset.find(ns + "unit")
        if u is not None and u.get("meter"):
            unit = float(u.get("meter"))
        ua = asset.find(ns + "up_axis")
        if ua is not None and ua.text:
            up = ua.text.strip()

    # id -> float array for every <source>
    sources: dict[str, np.ndarray] = {}
    strides: dict[str, int] = {}
    for src in findall(root, "source"):
        fa = src.find(ns + "float_array")
        if fa is None or not fa.text:
            continue
        arr = np.array(fa.text.split(), dtype=float)
        sid = src.get("id")
        stride = 3
        acc = src.find(f"{ns}technique_common/{ns}accessor")
        if acc is not None and acc.get("stride"):
            stride = int(acc.get("stride"))
        if sid:
            sources["#" + sid] = arr
            strides["#" + sid] = stride
    # <vertices id> indirection: maps to its POSITION source
    vert_map: dict[str, str] = {}
    for vs in findall(root, "vertices"):
        for inp in vs.findall(ns + "input"):
            if inp.get("semantic") == "POSITION":
                vid = vs.get("id")
                if vid:
                    vert_map["#" + vid] = inp.get("source")

    all_v, all_t = [], []
    base = 0
    for prim_tag in ("triangles", "polylist"):
        for prim in findall(root, prim_tag):
            v_src = None
            v_off = 0
            n_inputs = 0
            for inp in prim.findall(ns + "input"):
                n_inputs = max(n_inputs, int(inp.get("offset", 0)) + 1)
                if inp.get("semantic") == "VERTEX":
                    v_src = vert_map.get(inp.get("source"), inp.get("source"))
                    v_off = int(inp.get("offset", 0))
            if v_src is None or v_src not in sources:
                continue
            stride = strides.get(v_src, 3)
            verts = sources[v_src].reshape(-1, stride)[:, :3] * unit
            p = prim.find(ns + "p")
            if p is None or not p.text:
                continue
            idx = np.array(p.text.split(), dtype=np.int64)
            vidx = idx.reshape(-1, max(n_inputs, 1))[:, v_off]
            if prim_tag == "polylist":
                vc = prim.find(ns + "vcount")
                if vc is not None and vc.text:
                    counts = np.array(vc.text.split(), dtype=np.int64)
                    # fan-triangulate each polygon
                    tris, pos = [], 0
                    for c in counts:
                        poly = vidx[pos : pos + c]
                        for k in range(1, c - 1):
                            tris.append([poly[0], poly[k], poly[k + 1]])
                        pos += c
                    tri = np.asarray(tris, dtype=np.int64)
                else:
                    tri = vidx.reshape(-1, 3)
            else:
                tri = vidx.reshape(-1, 3)
            all_v.append(verts)
            all_t.append(tri + base)
            base += len(verts)
    if not all_v:
        raise ValueError(f"no triangle geometry found in DAE: {path}")
    V = np.concatenate(all_v, axis=0)
    T = np.concatenate(all_t, axis=0).astype(np.int32)
    if up == "Y_UP":  # rotate +Y-up into +Z-up (x, y, z) -> (x, -z, y)
        V = np.stack([V[:, 0], -V[:, 2], V[:, 1]], axis=1)
    elif up == "X_UP":  # (x, y, z) -> (-z, y, x)
        V = np.stack([-V[:, 2], V[:, 1], V[:, 0]], axis=1)
    return np.ascontiguousarray(V, dtype=float), T


def load_mesh_vertices(path: str) -> np.ndarray:
    """Vertices of an STL or DAE mesh file (format by extension)."""
    if path.lower().endswith(".dae"):
        return load_dae_mesh(path)[0]
    return load_stl_vertices(path)


def load_mesh_triangles(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices, triangles) of an STL or DAE mesh file."""
    if path.lower().endswith(".dae"):
        return load_dae_mesh(path)
    return load_stl_triangles(path)


def resolve_mesh_path(filename: str, urdf_path: str | None, mesh_base_dir: str = "meshes") -> str | None:
    """Resolve package:// and relative mesh URIs next to the URDF
    (reference: helpers.URDFHelpers loading package paths)."""
    if filename is None:
        return None
    f = filename
    if f.startswith("package://"):
        f = f[len("package://") :]
        # strip the package name, keep path below it
        parts = f.split("/", 1)
        f = parts[1] if len(parts) > 1 else parts[0]
    candidates = []
    if urdf_path:
        d = os.path.dirname(os.path.abspath(urdf_path))
        candidates += [os.path.join(d, f), os.path.join(d, os.path.basename(f))]
        # reference layout: meshes dir next to the model file
        candidates += [os.path.join(d, mesh_base_dir, os.path.basename(f))]
        sub = f.split("/")
        for k in range(1, len(sub)):
            candidates.append(os.path.join(d, *sub[k:]))
    candidates.append(f)
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def link_bounding_box(
    tree: RobotTree,
    link_name: str,
    fallback_center: np.ndarray | None = None,
    cube_size: float = 0.5,
    scale: float = 1.0,
    use_collision: bool = False,
    mesh_base_dir: str = "meshes",
):
    """Axis-aligned bounding box of a link's geometry in the link frame.

    Returns (box_min(3,), box_max(3,)). Falls back to a cube of
    `cube_size` around `fallback_center` when no geometry is available
    (reference: sdp.py:222-250 / helpers getBoundingBox semantics,
    incl. the hullScaling factor)."""
    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if use_collision and link.collisions else link.visuals
    pts = []
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = rpy_to_matrix(el.origin_rpy)
        p0 = el.origin_xyz
        if g.kind == "box":
            h = np.asarray(g.size) / 2.0
            corners = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            ) * h
            pts.append(corners @ R.T + p0)
        elif g.kind in ("cylinder", "capsule"):
            r, h = g.radius or 0.0, (g.length or 0.0) / 2.0
            if g.kind == "capsule":
                h = h + r
            corners = np.array(
                [[sx * r, sy * r, sz * h] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            )
            pts.append(corners @ R.T + p0)
        elif g.kind == "sphere":
            r = g.radius or 0.0
            corners = np.array(
                [[sx * r, sy * r, sz * r] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            )
            pts.append(corners @ R.T + p0)
        elif g.kind == "mesh":
            path = resolve_mesh_path(g.filename, tree.source_path, mesh_base_dir)
            if path is None:
                continue
            try:
                v = load_mesh_vertices(path)
            except (ValueError, OSError):
                continue
            if g.scale is not None:
                v = v * np.asarray(g.scale)
            pts.append(v @ R.T + p0)
    if not pts:
        c = np.zeros(3) if fallback_center is None else np.asarray(fallback_center)
        half = cube_size / 2.0
        return c - half, c + half
    allp = np.concatenate(pts, axis=0)
    lo, hi = allp.min(axis=0), allp.max(axis=0)
    center = (lo + hi) / 2.0
    halfw = (hi - lo) / 2.0 * scale
    return center - halfw, center + halfw
