"""Procedural test scenes (the port's copy of ``mcpt/scenes/procedural.py``;
numpy only, so every builder returns the same arrays as ``mcpt``'s).

The reference ships no scene geometry in git (`.gitignore` excludes ``*.obj``; only
``.mtl`` + ground-truth renders survive), so the framework carries procedural
builders: a Cornell box using the exact material palette of
``Scene/cbox/cbox.mtl`` (blue/glass/light/red/silver/white, classic geometry with
the camera of ``config.json:21-28`` — the shipped scene's milk-can/pitcher props
are approximated by the classic tall/short boxes), and analytic scenes with
closed-form expected radiance (furnace tests) used as physics oracles.
"""

from __future__ import annotations

import numpy as np

from mcpt_torch import types
from mcpt_torch.config import CameraConfig
from mcpt_torch.io.objloader import LoadedObject
from mcpt_torch.scene import loaded_from_arrays


def _quad(a, b, c, d):
    """Two CCW triangles for quad a-b-c-d."""
    return [(a, b, c), (a, c, d)]


def _box_faces(pmin, pmax):
    """The 6 quads (a, b, c, d) of an axis-aligned box, outward winding."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    p = {
        (i, j, k): ((x0, x1)[i], (y0, y1)[j], (z0, z1)[k])
        for i in (0, 1)
        for j in (0, 1)
        for k in (0, 1)
    }
    return [
        (p[0, 0, 0], p[0, 1, 0], p[1, 1, 0], p[1, 0, 0]),  # z = z0
        (p[0, 0, 1], p[1, 0, 1], p[1, 1, 1], p[0, 1, 1]),  # z = z1
        (p[0, 0, 0], p[0, 0, 1], p[0, 1, 1], p[0, 1, 0]),  # x = x0
        (p[1, 0, 0], p[1, 1, 0], p[1, 1, 1], p[1, 0, 1]),  # x = x1
        (p[0, 0, 0], p[1, 0, 0], p[1, 0, 1], p[0, 0, 1]),  # y = y0
        (p[0, 1, 0], p[0, 1, 1], p[1, 1, 1], p[1, 1, 0]),  # y = y1
    ]


def _box(pmin, pmax):
    """12 triangles of an axis-aligned box with outward normals."""
    tris = []
    for f in _box_faces(pmin, pmax):
        tris += _quad(*f)
    return tris


def _quad_tess(a, b, c, d, n: int):
    """Quad a-b-c-d split into an n×n bilinear grid (2·n² triangles) —
    tessellation makes flat surfaces BVH-deep like real scanned meshes."""
    a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))

    def pt(u, v):
        return tuple((a * (1 - u) + b * u) * (1 - v) + (d * (1 - u) + c * u) * v)

    tris = []
    for i in range(n):
        for j in range(n):
            u0, u1 = i / n, (i + 1) / n
            v0, v1 = j / n, (j + 1) / n
            tris += _quad(pt(u0, v0), pt(u1, v0), pt(u1, v1), pt(u0, v1))
    return tris


def _box_tess(pmin, pmax, n: int):
    """Box with each face tessellated n×n (12·n² triangles)."""
    tris = []
    for f in _box_faces(pmin, pmax):
        tris += _quad_tess(*f, n)
    return tris


# Material palette of Scene/cbox/cbox.mtl (verbatim values).
_CBOX_MATS = dict(
    blue=dict(Kd=(0.05, 0.05, 0.95)),
    glass=dict(Ni=1.5),
    light=dict(Ka=(10.0, 10.0, 10.0)),
    red=dict(Kd=(0.95, 0.05, 0.05)),
    silver=dict(Kd=(0.77, 0.79, 0.73), Ks=(0.97, 0.99, 0.93), Ns=98.0),
    white=dict(Kd=(0.85, 0.75, 0.65)),
)


def _pack_mats(order):
    m = len(order)
    mtype = np.zeros(m, np.int32)
    kd = np.zeros((m, 3), np.float32)
    ks = np.zeros((m, 3), np.float32)
    ka = np.zeros((m, 3), np.float32)
    ns = np.zeros(m, np.float32)
    ni = np.ones(m, np.float32)
    for i, name in enumerate(order):
        d = _CBOX_MATS[name] if name in _CBOX_MATS else {}
        if "Ni" in d and d["Ni"] != 1.0:
            mtype[i] = types.TRANSPARENT
            ni[i] = d["Ni"]
        elif "Ka" in d:
            mtype[i] = types.LIGHT
            ka[i] = d["Ka"]
        elif "Ns" in d:
            mtype[i] = types.GLOSSY
            kd[i] = d.get("Kd", (0, 0, 0))
            ks[i] = d["Ks"]
            ns[i] = d["Ns"]
        else:
            mtype[i] = types.DIFFUSE
            kd[i] = d.get("Kd", (0, 0, 0))
    return mtype, kd, ks, ka, ns, ni


def cornell_box(include_boxes: bool = True, tall_material: str = "silver",
                short_material: str = "glass") -> tuple[LoadedObject, CameraConfig]:
    """Classic Cornell box with the cbox.mtl palette.

    Red wall on +x (screen left for the reference camera, which looks down +z with
    right = -x), blue on x=0, white floor/ceiling/back, area light in the ceiling.
    """
    order = ["white", "red", "blue", "light", tall_material, short_material]
    names = {n: i for i, n in enumerate(order)}
    tris: list = []
    mat_id: list[int] = []

    def add(quads, m):
        tris.extend(quads)
        mat_id.extend([names[m]] * len(quads))

    # floor, ceiling, back wall — white
    add(_quad((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)), "white")
    add(
        _quad((556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0)),
        "white",
    )
    add(
        _quad((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2)),
        "white",
    )
    # left (+x) red, right (x=0) blue
    add(
        _quad((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0)),
        "red",
    )
    add(_quad((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)), "blue")
    # ceiling light (slightly below ceiling)
    add(
        _quad(
            (343, 548.75, 227), (343, 548.75, 332), (213, 548.75, 332), (213, 548.75, 227)
        ),
        "light",
    )
    if include_boxes:
        tall = _box((265, 0, 296), (430, 330, 456))
        tris.extend(tall)
        mat_id.extend([names[tall_material]] * len(tall))
        short = _box((130, 0, 65), (295, 165, 225))
        tris.extend(short)
        mat_id.extend([names[short_material]] * len(short))

    verts = np.asarray(tris, np.float32)
    mtype, kd, ks, ka, ns, ni = _pack_mats(order)
    loaded = loaded_from_arrays(verts, mat_id, mtype, kd, ks, ka, ns, ni, order)
    cam = CameraConfig(
        position=(278, 273, -800),
        lookat=(278, 273, -799),
        up=(0, 1, 0),
        fov=39.3077,
        resolution=(512, 512),
    )
    return loaded, cam


def icosphere(center, radius, subdiv: int = 2, flip: bool = False) -> np.ndarray:
    """Triangulated sphere; ``flip=True`` turns normals inward (enclosures)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdiv):
        new_faces = []
        cache: dict = {}
        vlist = list(verts)

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                cache[k] = len(vlist)
                vlist.append(m)
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(vlist)
    v = verts[np.asarray(faces)]  # (F, 3, 3)
    if flip:
        v = v[:, ::-1]
    return (np.asarray(v, np.float32) * radius + np.asarray(center, np.float32))


def furnace_sphere(albedo: float = 0.5, emission: float = 1.0, subdiv: int = 3):
    """Furnace test: a diffuse sphere (Kd = albedo) inside an inward-facing
    emissive enclosure (Ka = emission).  A convex diffuse body under uniform
    illumination E reflects exactly ρ·E in every direction, so a camera pixel
    covering the sphere must converge to ``albedo · emission`` and one covering
    the background to ``emission``.  Closed-form oracle for the whole integrator.
    """
    inner = icosphere((0, 0, 0), 1.0, subdiv=subdiv)
    outer = icosphere((0, 0, 0), 50.0, subdiv=2, flip=True)
    verts = np.concatenate([inner, outer])
    mat_id = np.concatenate(
        [np.zeros(len(inner), np.int32), np.ones(len(outer), np.int32)]
    )
    loaded = loaded_from_arrays(
        verts,
        mat_id,
        mtype=[types.DIFFUSE, types.LIGHT],
        kd=[[albedo] * 3, [0, 0, 0]],
        ks=np.zeros((2, 3)),
        ka=[[0, 0, 0], [emission] * 3],
        ns=[0.0, 0.0],
        ni=[1.0, 1.0],
    )
    cam = CameraConfig(
        position=(0, 0, 5), lookat=(0, 0, 0), up=(0, 1, 0), fov=30,
        resolution=(64, 64),
    )
    return loaded, cam


def veach_mis(n_plates: int = 4) -> tuple[LoadedObject, CameraConfig]:
    """Veach MIS-style scene: four glossy plates of increasing roughness lit by
    light sources of decreasing size/increasing intensity — the classic
    stress test for BSDF-vs-light sampling (the reference's second workload,
    ``Scene/veach_mis``; its .obj isn't shipped, so this is a procedurally
    built equivalent using the reference camera, ``config.json:44-55``)."""
    tris: list = []
    mat_id: list[int] = []

    def add(quads, m):
        tris.extend(quads)
        mat_id.extend([m] * len(quads))

    # materials: 0 floor diffuse, 1..4 glossy plates (Ns high→low),
    # 5..8 emitters (small/bright → large/dim)
    mtype = [types.DIFFUSE] + [types.GLOSSY] * n_plates + [types.LIGHT] * 4
    kd = [[0.4, 0.4, 0.4]] + [[0.03, 0.03, 0.03]] * n_plates + [[0, 0, 0]] * 4
    ks = [[0, 0, 0]] + [[0.9, 0.9, 0.9]] * n_plates + [[0, 0, 0]] * 4
    ka = [[0, 0, 0]] * (1 + n_plates) + [
        [901.0, 901.0, 901.0], [100.0, 100.0, 100.0],
        [11.1, 11.1, 11.1], [1.23, 1.23, 1.23],
    ]
    ns = [0.0] + [5000.0, 800.0, 120.0, 20.0][:n_plates] + [0.0] * 4
    ni = [1.0] * (1 + n_plates + 4)

    # floor + back wall
    add(_quad((-15, -5, -5), (-15, -5, 15), (15, -5, 15), (15, -5, -5)), 0)
    add(_quad((-15, -5, -6), (15, -5, -6), (15, 12, -6), (-15, 12, -6)), 0)

    cam_pos = np.array([0.0, 2.0, 15.0])
    light_center = np.array([0.0, 0.8, 0.0])
    # tilted plates: each plate's tilt solved so it mirrors the light row into
    # the camera (half-vector construction, the defining property of the scene)
    for i in range(n_plates):
        center = np.array([0.0, -1.2 - 0.95 * i, 3.2 - 1.1 * i])
        to_l = light_center - center
        to_c = cam_pos - center
        h = to_l / np.linalg.norm(to_l) + to_c / np.linalg.norm(to_c)
        n = h / np.linalg.norm(h)
        x_axis = np.array([1.0, 0, 0])
        t = np.cross(x_axis, n)
        t /= np.linalg.norm(t)
        w = 0.55  # half-width along the tilt direction
        p00 = center - 6 * x_axis - w * t
        p01 = center + 6 * x_axis - w * t
        p11 = center + 6 * x_axis + w * t
        p10 = center - 6 * x_axis + w * t
        add(_quad(tuple(p00), tuple(p01), tuple(p11), tuple(p10)), 1 + i)
    # sphere lights: equal power, increasing radius left→right
    radii = [0.05, 0.15, 0.45, 1.35]
    xs = [-4.5, -1.5, 1.5, 4.5]
    for i, (rad, x) in enumerate(zip(radii, xs)):
        sph = icosphere((x, light_center[1], light_center[2]), rad, subdiv=1)
        tris.extend(sph.tolist())
        mat_id.extend([1 + n_plates + i] * len(sph))

    loaded = loaded_from_arrays(
        np.asarray(tris, np.float32), mat_id, mtype, kd, ks, ka, ns, ni
    )
    cam = CameraConfig(
        position=(0, 2, 15), lookat=(0, -2, 2.5), up=(0, 1, 0), fov=28,
        resolution=(768, 512),
    )
    return loaded, cam


def boxfield(n_boxes: int = 9000, seed: int = 0):
    """Large-BVH stress scene (~12·n_boxes triangles): a field of randomly
    sized/placed boxes under a big area light — the stand-in for
    diningroom-class meshes (the reference's third workload, whose .obj is not
    shipped).  Exercises deep, divergent BVH traversal in the wavefront path."""
    rng = np.random.default_rng(seed)
    tris: list = []
    mat_id: list[int] = []
    g = 120.0
    tris += _quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g))
    mat_id += [0, 0]
    centers = rng.uniform(-100, 100, (n_boxes, 2))
    sizes = rng.uniform(0.4, 3.0, (n_boxes, 3))
    heights = rng.uniform(0.5, 8.0, n_boxes)
    for i in range(n_boxes):
        cx, cz = centers[i]
        sx, _, sz = sizes[i]
        b = _box((cx - sx, 0, cz - sz), (cx + sx, heights[i], cz + sz))
        tris += b
        mat_id += [1 + (i % 3)] * len(b)
    # sky light: large emissive quad high above
    tris += _quad((-150, 60, -150), (150, 60, -150), (150, 60, 150),
                  (-150, 60, 150))
    mat_id += [4, 4]
    loaded = loaded_from_arrays(
        np.asarray(tris, np.float32),
        mat_id,
        mtype=[types.DIFFUSE, types.DIFFUSE, types.GLOSSY, types.DIFFUSE,
               types.LIGHT],
        kd=[[0.5, 0.5, 0.5], [0.7, 0.3, 0.2], [0.1, 0.1, 0.1],
            [0.2, 0.4, 0.7], [0, 0, 0]],
        ks=[[0, 0, 0], [0, 0, 0], [0.8, 0.8, 0.8], [0, 0, 0], [0, 0, 0]],
        ka=[[0, 0, 0]] * 4 + [[3.0, 3.0, 3.0]],
        ns=[0, 0, 60.0, 0, 0],
        ni=[1.0] * 5,
    )
    cam = CameraConfig(
        position=(0, 25, 110), lookat=(0, 2, 0), up=(0, 1, 0), fov=50,
        resolution=(640, 360),
    )
    return loaded, cam


def diningroom(tess: int = 70) -> tuple[LoadedObject, CameraConfig]:
    """Procedural dining-room interior — the stand-in for the reference's
    third workload preset (``config.json:58-84``: 1280×720, fov 60, depth 8,
    512 spp; the shipped ``diningroom.obj`` is gitignored, only the .mtl and
    the 2048-spp EXR survive).  A closed room with two ceiling light panels,
    a table with glass/metal tableware, and six chairs: interior
    multi-bounce GI, glossy + transparent transport, and NEE from small
    emitters inside a ~100k-triangle mesh (surfaces are grid-tessellated so
    the BVH is as deep as a real scanned scene).

    ``tess`` scales triangle count: room faces are tess×tess, furniture
    tess/8, spheres icosphere(subdiv 3).  Default ≈ 100k triangles.
    """
    order = ["wall", "wood", "lamp", "cloth", "metal", "glass", "dish"]
    names = {n: i for i, n in enumerate(order)}
    ft = max(2, tess // 8)
    tris: list = []
    mat_id: list[int] = []

    def add(t, m):
        tris.extend(t)
        mat_id.extend([names[m]] * len(t))

    # room shell x∈[-3,3], y∈[0,2.8], z∈[-4,4] (inward-facing winding is
    # irrelevant: shading flips normals toward the ray)
    add(_quad_tess((-3, 0, -4), (3, 0, -4), (3, 0, 4), (-3, 0, 4), tess),
        "wood")  # floor
    add(_quad_tess((-3, 2.8, -4), (3, 2.8, -4), (3, 2.8, 4), (-3, 2.8, 4),
                   tess), "wall")  # ceiling
    add(_quad_tess((-3, 0, -4), (-3, 2.8, -4), (3, 2.8, -4), (3, 0, -4),
                   tess), "wall")  # back
    add(_quad_tess((-3, 0, 4), (3, 0, 4), (3, 2.8, 4), (-3, 2.8, 4), tess),
        "wall")  # front (behind camera)
    add(_quad_tess((-3, 0, -4), (-3, 0, 4), (-3, 2.8, 4), (-3, 2.8, -4),
                   tess), "wall")
    add(_quad_tess((3, 0, -4), (3, 2.8, -4), (3, 2.8, 4), (3, 0, 4), tess),
        "wall")
    # two ceiling lamp panels (just below the ceiling, facing down)
    for zc in (-1.3, 1.3):
        add(_quad((-0.6, 2.79, zc - 0.4), (0.6, 2.79, zc - 0.4),
                  (0.6, 2.79, zc + 0.4), (-0.6, 2.79, zc + 0.4)), "lamp")

    # dining table: top slab + 4 legs
    add(_box_tess((-1.1, 0.72, -0.65), (1.1, 0.78, 0.65), ft), "wood")
    for lx in (-1.0, 1.0):
        for lz in (-0.55, 0.55):
            add(_box_tess((lx - 0.04, 0, lz - 0.04), (lx + 0.04, 0.72,
                                                      lz + 0.04), ft), "wood")

    # six chairs around the table (seat, backrest, 4 legs each)
    def chair(cx, cz, face_x):
        s = 0.22  # half seat width
        add(_box_tess((cx - s, 0.42, cz - s), (cx + s, 0.47, cz + s), ft),
            "cloth")
        bx = cx + (s - 0.03) * face_x
        add(_box_tess((bx - 0.03, 0.47, cz - s), (bx + 0.03, 0.95, cz + s),
                      ft), "cloth")
        for dx in (-s + 0.03, s - 0.03):
            for dz in (-s + 0.03, s - 0.03):
                add(_box_tess((cx + dx - 0.02, 0, cz + dz - 0.02),
                              (cx + dx + 0.02, 0.42, cz + dz + 0.02), ft),
                    "wood")

    for cz in (-0.45, 0.45):
        chair(-1.55, cz, -1.0)
        chair(1.55, cz, 1.0)
    for cx in (-0.6, 0.6):
        chair(cx, -1.15, 0.0)

    # sideboard against the +x wall
    add(_box_tess((2.45, 0, -1.6), (2.95, 1.0, 1.6), ft), "wood")

    # tableware: glass + metal spheres, diffuse dishes
    for sx, sz, m in ((-0.55, -0.25, "glass"), (0.5, 0.3, "glass"),
                      (-0.15, 0.35, "metal"), (0.25, -0.35, "metal")):
        sph = icosphere((sx, 0.78 + 0.09, sz), 0.09, subdiv=3)
        add([tuple(map(tuple, t)) for t in sph], m)
    for dx, dz in ((-0.7, 0.3), (0.0, -0.15), (0.75, -0.2)):
        add(_box((dx - 0.1, 0.78, dz - 0.1), (dx + 0.1, 0.80, dz + 0.1)),
            "dish")

    verts = np.asarray(tris, np.float32)
    loaded = loaded_from_arrays(
        verts,
        mat_id,
        mtype=[types.DIFFUSE, types.GLOSSY, types.LIGHT, types.DIFFUSE,
               types.GLOSSY, types.TRANSPARENT, types.DIFFUSE],
        kd=[[0.73, 0.70, 0.64],  # wall
            [0.32, 0.20, 0.10],  # wood
            [0, 0, 0],           # lamp
            [0.55, 0.12, 0.12],  # cloth
            [0.05, 0.05, 0.05],  # metal
            [0, 0, 0],           # glass
            [0.85, 0.85, 0.80]],  # dish
        ks=[[0, 0, 0], [0.25, 0.18, 0.10], [0, 0, 0], [0, 0, 0],
            [0.85, 0.86, 0.88], [0, 0, 0], [0, 0, 0]],
        ka=[[0, 0, 0], [0, 0, 0], [14.0, 13.0, 11.5], [0, 0, 0], [0, 0, 0],
            [0, 0, 0], [0, 0, 0]],
        ns=[0, 30.0, 0, 0, 200.0, 0, 0],
        ni=[1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 1.0],
        names=order,
    )
    cam = CameraConfig(
        position=(0.0, 1.5, 3.6), lookat=(0.0, 1.0, 0.0), up=(0, 1, 0),
        fov=60.0, resolution=(1280, 720),
    )
    return loaded, cam


def quad_light_plane(light_y: float = 2.0, half: float = 0.5,
                     emission: float = 4.0, albedo: float = 0.6):
    """A diffuse ground plane lit by a square area light — closed-form direct
    illumination at the point under the light's center; exercises NEE/MIS paths
    against the plain BSDF-sampling estimator (both must agree)."""
    tris = []
    mat_id = []
    g = 50.0
    tris += _quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g))
    mat_id += [0, 0]
    tris += _quad(
        (-half, light_y, -half), (half, light_y, -half),
        (half, light_y, half), (-half, light_y, half),
    )
    mat_id += [1, 1]
    loaded = loaded_from_arrays(
        np.asarray(tris, np.float32),
        mat_id,
        mtype=[types.DIFFUSE, types.LIGHT],
        kd=[[albedo] * 3, [0, 0, 0]],
        ks=np.zeros((2, 3)),
        ka=[[0, 0, 0], [emission] * 3],
        ns=[0.0, 0.0],
        ni=[1.0, 1.0],
    )
    cam = CameraConfig(
        position=(0, 1.0, 4.0), lookat=(0, 0.5, 0), up=(0, 1, 0), fov=45,
        resolution=(64, 64),
    )
    return loaded, cam
