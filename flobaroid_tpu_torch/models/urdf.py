"""URDF parsing into a static robot-tree description.

The port's own copy of flobaroid_tpu/models/urdf.py (numpy and xml
only), cut to what the port calls: the parser, the tree and its
topology, `rpy_to_matrix`, the regressor-XML joint order and the writer
of identified parameters back into a URDF copy.

Replaces the reference's use of the iDynTree C++ ModelLoader
(reference: identification/model.py:60-67) with a self-contained
parser that produces plain numpy arrays plus static python metadata.
The static part is closed over by the JAX dynamics functions at trace
time (the tree topology never changes inside a jit), while inertial
parameters stay an explicit, differentiable vector.

Conventions (matching the reference / iDynTree):
  * links are numbered in URDF document order
    (reference: identification/model.py:122-126 uses iDynTree link ids),
  * every link carries 10 standard inertial parameters expressed in
    the *link frame* (not the COM frame):
        [m, m*c_x, m*c_y, m*c_z, I_xx, I_xy, I_xz, I_yy, I_yz, I_zz]
    (reference: identification/model.py:190-195 getInertialParameters),
  * fixed joints keep their child links as separate links with their
    own (usually zero / non-identifiable) parameter slots,
  * degrees of freedom are the movable joints in document order unless
    an explicit joint-name ordering is given (the reference reads it
    from a regressor XML, identification/model.py:74-94).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

MOVABLE_TYPES = ("revolute", "continuous", "prismatic")


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll/pitch/yaw to rotation matrix: Rz(y)@Ry(p)@Rx(r)."""
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def matrix_to_rpy(R: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rpy_to_matrix` (one solution, pitch in [-pi/2, pi/2])."""
    p = math.atan2(-R[2, 0], math.hypot(R[0, 0], R[1, 0]))
    if abs(abs(p) - math.pi / 2) < 1e-12:
        r = 0.0
        y = math.atan2(-R[0, 1], R[1, 1]) * (1.0 if p > 0 else -1.0)
    else:
        y = math.atan2(R[1, 0], R[0, 0])
        r = math.atan2(R[2, 1], R[2, 2])
    return np.array([r, p, y])


def _floats(s: str | None, default=None) -> np.ndarray:
    if s is None:
        return np.asarray(default, dtype=float)
    return np.array([float(x) for x in s.split()], dtype=float)


@dataclass
class Geometry:
    kind: str  # 'box' | 'cylinder' | 'sphere' | 'mesh' | 'capsule'
    size: np.ndarray | None = None  # box: (3,)
    radius: float | None = None  # cylinder / sphere / capsule
    length: float | None = None  # cylinder / capsule
    filename: str | None = None  # mesh
    scale: np.ndarray | None = None  # mesh


@dataclass
class VisualElement:
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    geometry: Geometry | None


@dataclass
class Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))  # in link frame
    # rotational inertia about the link-frame origin, in link-frame coords
    inertia_origin: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    visuals: list[VisualElement] = field(default_factory=list)
    collisions: list[VisualElement] = field(default_factory=list)

    @property
    def std_params(self) -> np.ndarray:
        """10 standard inertial params [m, h, Ixx, Ixy, Ixz, Iyy, Iyz, Izz]."""
        Io = self.inertia_origin
        return np.concatenate(
            (
                [self.mass],
                self.mass * self.com,
                [Io[0, 0], Io[0, 1], Io[0, 2], Io[1, 1], Io[1, 2], Io[2, 2]],
            )
        )


@dataclass
class Joint:
    name: str
    jtype: str  # 'revolute' | 'continuous' | 'prismatic' | 'fixed'
    parent: str
    child: str
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    axis: np.ndarray
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_effort: float = np.inf
    limit_velocity: float = np.inf
    damping: float = 0.0
    friction: float = 0.0  # Coulomb, from <dynamics friction=...>
    has_damping: bool = False  # explicit <dynamics damping> vs absent
    # <mimic joint=... multiplier=... offset=...>: this joint's
    # coordinate is q = multiplier * q_source + offset and it carries
    # no independent DOF (URDF spec; the reference inherits support via
    # iDynTree ModelLoader, reference identification/model.py:60-67)
    mimic_joint: str | None = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0


@dataclass
class Transmission:
    joint: str
    mechanical_reduction: float = 1.0
    motor_inertia: float = 0.0


@dataclass
class RobotTree:
    """Static description of a robot parsed from URDF."""

    name: str
    links: list[Link]
    joints: list[Joint]  # all joints, document order
    transmissions: dict[str, Transmission]
    source_path: str | None = None

    # derived topology, filled by _finalize()
    link_index: dict[str, int] = field(default_factory=dict)
    parent_link: np.ndarray | None = None  # (L,) parent link id, -1 for root
    parent_joint: list[int] | None = None  # (L,) joint id connecting to parent
    root: int = 0
    dof_joint_ids: list[int] = field(default_factory=list)  # joint id per dof
    dof_names: list[str] = field(default_factory=list)
    dof_link: np.ndarray | None = None  # (n,) child link id of each dof joint
    # mimic joints: (joint_id, source_dof_index, multiplier, offset) —
    # movable joints whose coordinate is a linear map of another DOF
    mimic_map: list[tuple[int, int, float, float]] = field(default_factory=list)

    def _finalize(self, joint_order: list[str] | None = None) -> None:
        self.link_index = {l.name: i for i, l in enumerate(self.links)}
        L = len(self.links)
        self.parent_link = np.full(L, -1, dtype=int)
        self.parent_joint = [-1] * L
        has_parent = [False] * L
        for ji, j in enumerate(self.joints):
            ci = self.link_index[j.child]
            self.parent_link[ci] = self.link_index[j.parent]
            self.parent_joint[ci] = ji
            has_parent[ci] = True
        roots = [i for i in range(L) if not has_parent[i]]
        if len(roots) != 1:
            raise ValueError(f"URDF must have exactly one root link, found {roots}")
        self.root = roots[0]

        # FAIL LOUDLY on joint types the engine cannot represent: the
        # reference inherits full URDF semantics from iDynTree ModelLoader
        # (reference identification/model.py:60-67); silently treating a
        # planar/floating/unknown joint as fixed drops DOFs and produces
        # wrong identifications with no error. A URDF `floating` joint is
        # deliberately unsupported: floating-base dynamics are selected
        # via the `floatingBase` config key, matching the reference.
        known = set(MOVABLE_TYPES) | {"fixed"}
        for j in self.joints:
            if j.jtype not in known:
                hint = (
                    " (floating-base dynamics are configured with "
                    "floatingBase: 1, not with a URDF floating joint)"
                    if j.jtype == "floating" else ""
                )
                raise ValueError(
                    f"unsupported joint type '{j.jtype}' on joint "
                    f"'{j.name}': supported types are "
                    f"{sorted(known)} plus mimic joints{hint}"
                )

        movable = [(ji, j) for ji, j in enumerate(self.joints)
                   if j.jtype in MOVABLE_TYPES and j.mimic_joint is None]
        if joint_order is not None:
            by_name = {j.name: ji for ji, j in movable}
            missing = [n for n in joint_order if n not in by_name]
            if missing:
                raise ValueError(f"joint order names not in model: {missing}")
            self.dof_joint_ids = [by_name[n] for n in joint_order]
        else:
            self.dof_joint_ids = [ji for ji, _ in movable]
        self.dof_names = [self.joints[ji].name for ji in self.dof_joint_ids]
        self.dof_link = np.array(
            [self.link_index[self.joints[ji].child] for ji in self.dof_joint_ids], dtype=int
        )

        # mimic joints: movable, but their coordinate is a linear map of
        # another DOF (no independent column in q)
        self.mimic_map = []
        dof_of_name = {self.joints[ji].name: d
                       for d, ji in enumerate(self.dof_joint_ids)}
        for ji, j in enumerate(self.joints):
            if j.mimic_joint is None or j.jtype not in MOVABLE_TYPES:
                continue
            src = dof_of_name.get(j.mimic_joint)
            if src is None:
                raise ValueError(
                    f"mimic joint '{j.name}' references '{j.mimic_joint}', "
                    "which is not an independent movable joint (missing, "
                    "fixed, or itself a mimic joint — chained mimics are "
                    "not supported)"
                )
            self.mimic_map.append(
                (ji, src, float(j.mimic_multiplier), float(j.mimic_offset))
            )

    # ------------------------------------------------------------------
    @property
    def num_links(self) -> int:
        return len(self.links)

    @property
    def num_dofs(self) -> int:
        return len(self.dof_joint_ids)

    @property
    def link_names(self) -> list[str]:
        return [l.name for l in self.links]

    def std_params(self) -> np.ndarray:
        """Stacked (10*L,) a-priori standard inertial parameter vector."""
        return np.concatenate([l.std_params for l in self.links])

    def joint_limits(self, use_deg: bool = False) -> dict[str, dict[str, float]]:
        """Per-joint limits, mirroring helpers.URDFHelpers.getJointLimits
        (reference: identification/helpers.py)."""
        out = {}
        s = 180.0 / math.pi if use_deg else 1.0
        for ji in self.dof_joint_ids:
            j = self.joints[ji]
            lo, hi = j.limit_lower, j.limit_upper
            if j.jtype == "continuous" and not np.isfinite(lo):
                lo, hi = -math.pi, math.pi
            out[j.name] = {
                "lower": lo * s,
                "upper": hi * s,
                "velocity": j.limit_velocity * (s if j.jtype != "prismatic" else 1.0),
                "torque": j.limit_effort,
            }
        return out

    def topo_order(self) -> list[int]:
        """Link indices sorted root-first (parents before children)."""
        order: list[int] = []
        children: dict[int, list[int]] = {}
        for i in range(self.num_links):
            if i != self.root:
                children.setdefault(int(self.parent_link[i]), []).append(i)
        stack = [self.root]
        while stack:
            i = stack.pop()
            order.append(i)
            stack.extend(reversed(children.get(i, [])))
        return order

    def ancestors(self, link: int) -> list[int]:
        """All ancestor link ids of `link`, root-first (excluding link itself)."""
        anc: list[int] = []
        i = link
        while int(self.parent_link[i]) >= 0:
            i = int(self.parent_link[i])
            anc.append(i)
        return anc[::-1]


def _parse_geometry(geom_el: ET.Element | None) -> Geometry | None:
    if geom_el is None:
        return None
    for child in geom_el:
        tag = child.tag
        if tag == "box":
            return Geometry("box", size=_floats(child.get("size"), [0, 0, 0]))
        if tag == "cylinder":
            return Geometry(
                "cylinder",
                radius=float(child.get("radius", 0)),
                length=float(child.get("length", 0)),
            )
        if tag == "sphere":
            return Geometry("sphere", radius=float(child.get("radius", 0)))
        if tag == "mesh":
            scale = child.get("scale")
            return Geometry(
                "mesh",
                filename=child.get("filename"),
                scale=_floats(scale, [1, 1, 1]) if scale else np.ones(3),
            )
        if tag == "capsule":  # non-standard but used by some models
            return Geometry(
                "capsule",
                radius=float(child.get("radius", 0)),
                length=float(child.get("length", 0)),
            )
    return None


def _parse_visual(el: ET.Element) -> VisualElement:
    origin = el.find("origin")
    xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
    rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
    return VisualElement(xyz, rpy, _parse_geometry(el.find("geometry")))


def load_urdf(
    path_or_string: str,
    joint_order: list[str] | None = None,
    normalize_axes: bool = True,
) -> RobotTree:
    """Parse a URDF file (or XML string) into a :class:`RobotTree`.

    joint_order: optional explicit DOF ordering by joint name (the
    reference reads this from a regressor XML whitelist,
    identification/model.py:74-88).
    """
    if path_or_string.lstrip().startswith("<"):
        root = ET.fromstring(path_or_string)
        source = None
    else:
        root = ET.parse(path_or_string).getroot()
        source = path_or_string
    if root.tag != "robot":
        raise ValueError(f"not a URDF robot element: {root.tag}")

    links: list[Link] = []
    joints: list[Joint] = []
    transmissions: dict[str, Transmission] = {}

    for el in root:
        if el.tag == "link":
            link = Link(name=el.get("name", f"link{len(links)}"))
            inertial = el.find("inertial")
            if inertial is not None:
                mass_el = inertial.find("mass")
                m = float(mass_el.get("value", 0)) if mass_el is not None else 0.0
                origin = inertial.find("origin")
                c_xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
                c_rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
                inertia_el = inertial.find("inertia")
                if inertia_el is not None:
                    ixx = float(inertia_el.get("ixx", 0))
                    ixy = float(inertia_el.get("ixy", 0))
                    ixz = float(inertia_el.get("ixz", 0))
                    iyy = float(inertia_el.get("iyy", 0))
                    iyz = float(inertia_el.get("iyz", 0))
                    izz = float(inertia_el.get("izz", 0))
                    I_com = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                else:
                    I_com = np.zeros((3, 3))
                # rotate the COM-frame inertia into link-frame orientation and
                # shift it to the link origin (parallel-axis theorem); this is
                # exactly the "about link frame" convention of the reference's
                # 10-parameter layout (identification/model.py:190-195).
                R = rpy_to_matrix(c_rpy)
                I_rot = R @ I_com @ R.T
                c = c_xyz
                I_origin = I_rot + m * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
                link.mass = m
                link.com = c
                link.inertia_origin = I_origin
            for v in el.findall("visual"):
                link.visuals.append(_parse_visual(v))
            for cgeom in el.findall("collision"):
                link.collisions.append(_parse_visual(cgeom))
            links.append(link)
        elif el.tag == "joint":
            jtype = el.get("type", "fixed")
            origin = el.find("origin")
            xyz = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
            rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
            axis_el = el.find("axis")
            axis = _floats(axis_el.get("xyz") if axis_el is not None else None, [1, 0, 0])
            if normalize_axes and jtype in MOVABLE_TYPES:
                n = np.linalg.norm(axis)
                if n > 0:
                    axis = axis / n
            parent_el = el.find("parent")
            child_el = el.find("child")
            if parent_el is None or child_el is None:
                continue
            joint = Joint(
                name=el.get("name", f"joint{len(joints)}"),
                jtype=jtype,
                parent=parent_el.get("link"),
                child=child_el.get("link"),
                origin_xyz=xyz,
                origin_rpy=rpy,
                axis=axis,
            )
            limit = el.find("limit")
            if limit is not None:
                joint.limit_lower = float(limit.get("lower", -np.inf))
                joint.limit_upper = float(limit.get("upper", np.inf))
                joint.limit_effort = float(limit.get("effort", np.inf))
                joint.limit_velocity = float(limit.get("velocity", np.inf))
            dyn = el.find("dynamics")
            if dyn is not None:
                joint.damping = float(dyn.get("damping", 0))
                joint.has_damping = "damping" in dyn.attrib
                joint.friction = float(dyn.get("friction", 0))
            mim = el.find("mimic")
            if mim is not None:
                joint.mimic_joint = mim.get("joint")
                joint.mimic_multiplier = float(mim.get("multiplier", 1.0))
                joint.mimic_offset = float(mim.get("offset", 0.0))
            joints.append(joint)
        elif el.tag == "transmission":
            jname = None
            reduction = 1.0
            motor_inertia = 0.0
            j_el = el.find("joint")
            if j_el is not None:
                jname = j_el.get("name")
            for tag in ("mechanicalReduction", "actuator/mechanicalReduction"):
                red = el.find(tag)
                if red is not None and red.text:
                    reduction = float(red.text)
            act = el.find("actuator")
            if act is not None:
                red = act.find("mechanicalReduction")
                if red is not None and red.text:
                    reduction = float(red.text)
                mi = act.find("motorInertia")
                if mi is not None and mi.text:
                    motor_inertia = float(mi.text)
            if jname:
                transmissions[jname] = Transmission(jname, reduction, motor_inertia)

    tree = RobotTree(
        name=root.get("name", "robot"),
        links=links,
        joints=joints,
        transmissions=transmissions,
        source_path=source,
    )
    tree._finalize(joint_order)
    return tree


def joint_names_from_regressor_xml(path: str) -> list[str]:
    """Read the DOF ordering from a reference-style regressor XML
    (reference: identification/model.py:74-88)."""
    with open(path) as f:
        tree = ET.fromstring(f.read())
    return [el.text or "" for el in tree.iter() if el.tag == "joint"]


def replace_params_in_urdf(
    input_path: str,
    output_path: str,
    new_params: np.ndarray,
    link_names: list[str],
    friction: dict[str, dict[str, float]] | None = None,
) -> None:
    """Write identified standard parameters back into a URDF copy.

    new_params: (10*L,) in the standard link-frame layout. The COM-frame
    inertia written out is recovered via the inverse parallel-axis shift.
    Mirrors helpers.URDFHelpers.replaceParamsInURDF in the reference.
    """
    tree = ET.parse(input_path)
    root = tree.getroot()
    by_name = {name: i for i, name in enumerate(link_names)}
    for el in root.findall("link"):
        name = el.get("name")
        if name not in by_name:
            continue
        p = new_params[by_name[name] * 10 : by_name[name] * 10 + 10]
        m = float(p[0])
        inertial = el.find("inertial")
        if inertial is None:
            if m == 0.0:
                continue
            inertial = ET.SubElement(el, "inertial")
        com = (p[1:4] / m) if m > 1e-12 else np.zeros(3)
        I_origin = np.array(
            [
                [p[4], p[5], p[6]],
                [p[5], p[7], p[8]],
                [p[6], p[8], p[9]],
            ]
        )
        I_com = I_origin - m * (np.dot(com, com) * np.eye(3) - np.outer(com, com))
        mass_el = inertial.find("mass")
        if mass_el is None:
            mass_el = ET.SubElement(inertial, "mass")
        mass_el.set("value", repr(m))
        origin_el = inertial.find("origin")
        if origin_el is None:
            origin_el = ET.SubElement(inertial, "origin")
        origin_el.set("xyz", " ".join(repr(float(x)) for x in com))
        origin_el.set("rpy", "0 0 0")
        inertia_el = inertial.find("inertia")
        if inertia_el is None:
            inertia_el = ET.SubElement(inertial, "inertia")
        inertia_el.set("ixx", repr(float(I_com[0, 0])))
        inertia_el.set("ixy", repr(float(I_com[0, 1])))
        inertia_el.set("ixz", repr(float(I_com[0, 2])))
        inertia_el.set("iyy", repr(float(I_com[1, 1])))
        inertia_el.set("iyz", repr(float(I_com[1, 2])))
        inertia_el.set("izz", repr(float(I_com[2, 2])))
    if friction:
        for el in root.findall("joint"):
            jn = el.get("name")
            if jn in friction:
                dyn = el.find("dynamics")
                if dyn is None:
                    dyn = ET.SubElement(el, "dynamics")
                if "damping" in friction[jn]:
                    dyn.set("damping", repr(float(friction[jn]["damping"])))
                if "friction" in friction[jn]:
                    dyn.set("friction", repr(float(friction[jn]["friction"])))
    tree.write(output_path, xml_declaration=True)
