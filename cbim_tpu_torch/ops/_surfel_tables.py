"""First-principles marching-cubes surfel tables (the port's own copy of
``cbim_tpu/ops/_surfel_tables.py``, numpy only; the port imports nothing of
``cbim_tpu``, and ``tests/test_torch_metrics.py`` holds the two equal).

The reference vendors the DeepMind surface-distance metric
(metric/metrics.py:265-553, metric/lookup_tables.py), whose HD/ASD are
*area-weighted* over surface elements: every voxel-corner with a non-trivial
2x2x2 neighbour code contributes the area of the marching-cubes triangles
that separate inside from outside within that 2x2x2 cell, with triangle
vertices at cube-edge midpoints.

This module DERIVES those per-code triangle sets from the marching-cubes
geometry instead of shipping a 256-entry literal table:

 1. corners of the unit cube are bit-indexed to match the reference's
    encoding kernel (bit weight 128 >> (4*x0 + 2*x1 + x2),
    metric/lookup_tables.py:45);
 2. for each code, the crossed edges (one endpoint inside, one outside) are
    linked into closed loops by walking the 6 faces — on an ambiguous face
    (two diagonal corners of one phase) the crossings are paired so the
    MINORITY phase of the whole cube is separated, reproducing the classic
    Lorensen-Cline base-case/complement table;
 3. each loop is fan-triangulated; the triangle normal
    cross(v1-v0, v2-v0)/2 encodes the area by its length, and anisotropic
    spacing scales component i by the product of the other two spacings
    (metric/lookup_tables.py:591-635 semantics).
"""

from __future__ import annotations

import itertools

import numpy as np


def _corner_coords(bit_index: int):
    """bit weight 128 >> b  <->  corner (x0, x1, x2) with b = 4*x0+2*x1+x2."""
    return ((bit_index >> 2) & 1, (bit_index >> 1) & 1, bit_index & 1)


_CORNERS = [_corner_coords(b) for b in range(8)]
_CORNER_INDEX = {c: i for i, c in enumerate(_CORNERS)}

# 12 cube edges as (corner_bit_a, corner_bit_b), a < b, differing in one axis
_EDGES = []
for a, b in itertools.combinations(range(8), 2):
    ca, cb = _CORNERS[a], _CORNERS[b]
    if sum(x != y for x, y in zip(ca, cb)) == 1:
        _EDGES.append((a, b))
_EDGE_INDEX = {e: i for i, e in enumerate(_EDGES)}

# 6 faces as ordered corner cycles (walk the face boundary)
_FACES = []
for axis in range(3):
    for val in (0, 1):
        cycle = []
        # boundary cycle of the square in the two free axes
        for u, v in ((0, 0), (0, 1), (1, 1), (1, 0)):
            coord = [None, None, None]
            coord[axis] = val
            free = [i for i in range(3) if i != axis]
            coord[free[0]], coord[free[1]] = u, v
            cycle.append(_CORNER_INDEX[tuple(coord)])
        _FACES.append(cycle)


def _edge_key(a: int, b: int):
    return (a, b) if a < b else (b, a)


def _face_pairings(cycle, inside, separate_phase_corner):
    """Pair the crossed boundary edges of one face into contour segments.

    ``separate_phase_corner(c)`` is True for corners of the phase whose
    diagonal pair must be separated when the face is ambiguous (4 crossings).
    Returns a list of (edge_key, edge_key) links.
    """
    cross = []
    for i in range(4):
        a, b = cycle[i], cycle[(i + 1) % 4]
        if inside[a] != inside[b]:
            cross.append((i, _edge_key(a, b)))
    if not cross:
        return []
    if len(cross) == 2:
        return [(cross[0][1], cross[1][1])]
    # ambiguous: 4 crossings; each contour segment wraps one corner of the
    # separated phase (the two diagonal corners of that phase on this face)
    links = []
    for i in range(4):
        a = cycle[i]
        if separate_phase_corner(a):
            prev_e = _edge_key(cycle[(i - 1) % 4], a)
            next_e = _edge_key(a, cycle[(i + 1) % 4])
            links.append((prev_e, next_e))
    assert len(links) == 2, links
    return links


def _loops_for_code(code: int):
    """Closed loops of crossed-edge midpoints for one neighbour code."""
    inside = [(code >> (7 - b)) & 1 == 1 for b in range(8)]
    # == bit weight 128 >> b set
    n_in = sum(inside)
    if n_in == 0 or n_in == 8:
        return []

    # classic complement convention: the minority phase is the one whose
    # diagonal face-corners get separated (for the 4-4 tie, separate inside)
    minority_is_inside = n_in <= 4

    def separate(c):
        return inside[c] == minority_is_inside

    adj = {}
    for cycle in _FACES:
        for e1, e2 in _face_pairings(cycle, inside, separate):
            adj.setdefault(e1, []).append(e2)
            adj.setdefault(e2, []).append(e1)

    for e, nbrs in adj.items():
        assert len(nbrs) == 2, (code, e, nbrs)

    loops = []
    visited = set()
    for start in adj:
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [e for e in adj[cur] if e != prev]
            # when both neighbours equal prev (2-edge loop) take either
            nxt = nxt[0] if nxt else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _midpoint(edge_key):
    a, b = edge_key
    ca, cb = _CORNERS[a], _CORNERS[b]
    return np.array([(x + y) / 2.0 for x, y in zip(ca, cb)])


def _triangulations(poly):
    """All triangulations of a polygon given as an index list (n <= 7)."""
    if len(poly) == 3:
        return [[tuple(poly)]]
    out = []
    a, b = poly[0], poly[1]
    for k in range(2, len(poly)):
        left, right = poly[1:k + 1], [poly[0]] + poly[k:]
        for l in (_triangulations(left) if len(left) >= 3 else [[]]):
            for r in (_triangulations(right) if len(right) >= 3 else [[]]):
                out.append([(a, b, poly[k])] + l + r)
    return out


def _loop_normals(pts):
    """Triangle normals of the MAXIMUM-area triangulation of a loop.

    The loops are non-planar for 5/6-vertex cases, so the surface area
    depends on the triangulation; the classic marching-cubes figures (and
    hence the reference's vendored table) correspond to the triangulation
    with the largest total area at UNIT spacing — verified exactly against
    metric/lookup_tables.py in tests/test_metrics.py.
    """
    best, best_area = None, -1.0
    for tri in _triangulations(list(range(len(pts)))):
        normals = [np.cross(pts[j] - pts[i], pts[k] - pts[i]) / 2.0
                   for i, j, k in tri]
        area = sum(np.linalg.norm(n) for n in normals)
        if area > best_area + 1e-12:
            best, best_area = normals, area
    return best


def neighbour_code_to_normals():
    """256-entry list: per code, an (n_tri, 3) array of triangle normals
    (cross(v1-v0, v2-v0)/2), vertices at edge midpoints."""
    tables = []
    for code in range(256):
        normals = []
        for loop in _loops_for_code(code):
            root = int(np.argmin([_EDGE_INDEX[e] for e in loop]))
            loop = loop[root:] + loop[:root]
            pts = [_midpoint(e) for e in loop]
            normals.extend(_loop_normals(pts))
        tables.append(np.array(normals) if normals
                      else np.zeros((0, 3), np.float64))
    return tables


_NORMALS_CACHE = None


def create_table_neighbour_code_to_surface_area(spacing):
    """Surface area per neighbour code for the given (s0, s1, s2) spacing.

    Component i of each normal scales with the product of the OTHER two
    spacings; the area is the scaled normal's euclidean length
    (metric/lookup_tables.py:591-635 semantics).
    """
    global _NORMALS_CACHE
    if _NORMALS_CACHE is None:
        _NORMALS_CACHE = neighbour_code_to_normals()
    s0, s1, s2 = float(spacing[0]), float(spacing[1]), float(spacing[2])
    scale = np.array([s1 * s2, s0 * s2, s0 * s1])
    area = np.zeros(256)
    for code, normals in enumerate(_NORMALS_CACHE):
        if len(normals):
            area[code] = np.linalg.norm(normals * scale, axis=1).sum()
    return area


def encode_kernel_3d():
    """2x2x2 correlate kernel: weight 128 >> (4*d0 + 2*d1 + d2)
    (metric/lookup_tables.py:45)."""
    k = np.zeros((2, 2, 2), np.uint8)
    for b in range(8):
        d = _corner_coords(b)
        k[d] = 128 >> b
    return k


# ---------------------------------------------------------------------------
# 2D: contour lengths (metric/lookup_tables.py:649-761 semantics)
# ---------------------------------------------------------------------------

def encode_kernel_2d():
    """2x2 correlate kernel: weight 8 >> (2*d0 + d1)."""
    k = np.zeros((2, 2), np.uint8)
    for b in range(4):
        k[(b >> 1) & 1, b & 1] = 8 >> b
    return k


def create_table_neighbour_code_to_contour_length(spacing):
    """Contour length per 2x2 neighbour code, derived the same way as the 3D
    table: crossed-edge midpoints of the unit square linked into segments
    (a diagonal-pair code contributes one segment around each corner of the
    cube's minority phase, 2*diag either way)."""
    s0, s1 = float(spacing[0]), float(spacing[1])
    corners = [((b >> 1) & 1, b & 1) for b in range(4)]
    cidx = {c: i for i, c in enumerate(corners)}
    # boundary cycle of the square
    cycle = [cidx[(0, 0)], cidx[(0, 1)], cidx[(1, 1)], cidx[(1, 0)]]

    def midpoint(a, b):
        ca, cb = corners[a], corners[b]
        return np.array([(ca[0] + cb[0]) / 2.0, (ca[1] + cb[1]) / 2.0])

    table = np.zeros(16)
    for code in range(16):
        inside = [(code >> (3 - b)) & 1 == 1 for b in range(4)]
        n_in = sum(inside)
        if n_in in (0, 4):
            continue
        cross = []
        for i in range(4):
            a, b = cycle[i], cycle[(i + 1) % 4]
            if inside[a] != inside[b]:
                cross.append((i, (a, b)))
        if len(cross) == 2:
            segs = [(cross[0][1], cross[1][1])]
        else:  # diagonal pair: one segment around each minority corner
            minority_is_inside = n_in <= 2
            segs = []
            for i in range(4):
                a = cycle[i]
                if inside[a] == minority_is_inside:
                    segs.append(((cycle[(i - 1) % 4], a),
                                 (a, cycle[(i + 1) % 4])))
        total = 0.0
        for e1, e2 in segs:
            d = midpoint(*e1) - midpoint(*e2)
            total += float(np.hypot(d[0] * s0, d[1] * s1))
        table[code] = total
    return table
