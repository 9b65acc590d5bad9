"""Gauss quadrature rules on the unit reference elements.

Domain and boundary rules for CUBE (tensor-product Gauss-Legendre on [0,1]^d)
and SIMPLEX (symmetric triangle/tetrahedron rules of degree 5/6/8).  The
numeric point/weight constants are the standard published values (the same
ones tabulated in the reference's 103_Integrations.jl).  Boundary rules
return, per local face: quad positions in the *element* reference frame,
weights, and reference tangent frames whose push-forward yields outward
normals and surface Jacobians.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Tuple

import numpy as np

# -- 1D Gauss-Legendre on [-1,1], orders 1..4 points --------------------------
_GL_POS = (
    (0.0,),
    (-1.0 / math.sqrt(3.0), 1.0 / math.sqrt(3.0)),
    (-math.sqrt(3.0 / 5.0), 0.0, math.sqrt(3.0 / 5.0)),
    (-math.sqrt(3.0 / 7.0 + 2.0 / 7.0 * math.sqrt(6.0 / 5.0)),
     -math.sqrt(3.0 / 7.0 - 2.0 / 7.0 * math.sqrt(6.0 / 5.0)),
     math.sqrt(3.0 / 7.0 - 2.0 / 7.0 * math.sqrt(6.0 / 5.0)),
     math.sqrt(3.0 / 7.0 + 2.0 / 7.0 * math.sqrt(6.0 / 5.0))),
)
_GL_WEIGHT = (
    (2.0,),
    (1.0, 1.0),
    (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0),
    ((18.0 - math.sqrt(30.0)) / 36.0, (18.0 + math.sqrt(30.0)) / 36.0,
     (18.0 + math.sqrt(30.0)) / 36.0, (18.0 - math.sqrt(30.0)) / 36.0),
)


def gauss_1d(itg_order: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point rule on [0,1], exact to polynomial degree itg_order."""
    n = math.ceil((itg_order + 1) / 2)
    if n > 4:
        # beyond the tabulated 4 points, fall back to numpy's generator
        x, w = np.polynomial.legendre.leggauss(n)
        return (x + 1.0) / 2.0, w / 2.0
    return (np.asarray(_GL_POS[n - 1]) / 2.0 + 0.5,
            np.asarray(_GL_WEIGHT[n - 1]) / 2.0)


def cube_domain(itg_order: int, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tensor-product rule on [0,1]^dim: (pos[nq, dim], weight[nq])."""
    x, w = gauss_1d(itg_order)
    pts, wts = [], []
    for combo in itertools.product(range(len(x)), repeat=dim):
        pts.append([x[c] for c in combo])
        wts.append(float(np.prod([w[c] for c in combo])))
    return np.asarray(pts), np.asarray(wts)


# Local face conventions (documented in structures.py):
# quad  faces: 1 bottom(y=0) 2 right(x=1) 3 top(y=1) 4 left(x=0)
# hex   faces: 1 z=0, 2 y=0, 3 x=1, 4 y=1, 5 x=0, 6 z=1

def cube_boundary(itg_order: int, dim: int):
    """Per-face rules: list of (pos[nq, dim], weight[nq],
    tangent[nq, dim, dim-1]).  Tangent frames chosen so that
    (2D) rotating t by -90° / (3D) t1 x t2 points outward."""
    x, w = gauss_1d(itg_order)
    if dim == 2:
        nq = len(x)
        faces = []
        specs = [  # (fixed axis, fixed value, tangent direction)
            (1, 0.0, np.array([1.0, 0.0])),    # bottom: outward (0,-1)
            (0, 1.0, np.array([0.0, 1.0])),    # right:  outward (1,0)
            (1, 1.0, np.array([-1.0, 0.0])),   # top:    outward (0,1)
            (0, 0.0, np.array([0.0, -1.0])),   # left:   outward (-1,0)
        ]
        for ax, val, tan in specs:
            pos = np.zeros((nq, 2))
            pos[:, 1 - ax] = x
            pos[:, ax] = val
            tang = np.broadcast_to(tan.reshape(1, 2, 1), (nq, 2, 1)).copy()
            faces.append((pos, w.copy(), tang))
        return faces
    if dim == 3:
        pos2, w2 = cube_domain(itg_order, 2)
        nq = len(w2)
        # (fixed axis, value, in-face axes (u,v) with t1=e_u, t2=e_v such
        #  that e_u x e_v = outward normal)
        specs = [
            (2, 0.0, (1, 0)),  # z=0: n=(0,0,-1) = e_y x e_x
            (1, 0.0, (0, 2)),  # y=0: n=(0,-1,0) = e_x x e_z
            (0, 1.0, (1, 2)),  # x=1: n=(1,0,0)  = e_y x e_z
            (1, 1.0, (2, 0)),  # y=1: n=(0,1,0)  = e_z x e_x
            (0, 0.0, (2, 1)),  # x=0: n=(-1,0,0) = e_z x e_y
            (2, 1.0, (0, 1)),  # z=1: n=(0,0,1)  = e_x x e_y
        ]
        faces = []
        for ax, val, (u, v) in specs:
            pos = np.zeros((nq, 3))
            pos[:, u] = pos2[:, 0]
            pos[:, v] = pos2[:, 1]
            pos[:, ax] = val
            tang = np.zeros((nq, 3, 2))
            tang[:, u, 0] = 1.0
            tang[:, v, 1] = 1.0
            faces.append((pos, w2.copy(), tang))
        return faces
    raise ValueError("cube boundary rules defined for dim 2, 3")


# -- symmetric simplex rules (barycentric orbits), degrees 5 / 6 / 8 ----------
# orbit notation: () = centroid; (a,) = perm31/perm21; (-a,) = perm22 (tet);
# (a, b) = full permutations of (a, b, rest)

_TRI_ORBITS = (
    # degree 5
    (((0.10128650732345633880098736191512383,),
      (0.47014206410511508977044120951344760,),
      ()),
     (0.12593918054482715259568394550018133,
      0.13239415278850618073764938783315200,
      9.0 / 40.0)),
    # degree 6
    (((0.06308901449150222834033160287081916,),
      (0.24928674517091042129163855310701908,),
      (0.05314504984481694735324967163139815,
       0.31035245103378440541660773395655215)),
     (0.05084490637020681692093680910686898,
      0.11678627572637936602528961138557944,
      0.08285107561837357519355345642044245)),
    # degree 8
    (((),
      (0.17056930775176020662229350149146450,),
      (0.05054722831703097545842355059659895,),
      (0.45929258829272315602881551449416932,),
      (0.26311282963463811342178578628464359,
       0.00839477740995760533721383453929445)),
     (0.14431560767778716825109111048906462,
      0.10321737053471825028179155029212903,
      0.03245849762319808031092592834178060,
      0.09509163426728462479389610438858432,
      0.02723031417443499426484469007390892)),
)

_TET_ORBITS = (
    # degree 5
    (((0.31088591926330060979734573376345783,),
      (0.09273525031089122640232391373703061,),
      (-0.04550370412564964949188052627933943,)),
     (0.11268792571801585079918565233328633,
      0.07349304311636194954371020548632750,
      0.04254602077708146643806942812025744)),
    # degree 6
    (((0.21460287125915202928883921938628499,),
      (0.04067395853461135311557944895641006,),
      (0.32233789014227551034399447076249213,),
      (0.06366100187501752529923552760572698,
       0.60300566479164914136743113906093969)),
     (0.03992275025816749209969062755747998,
      0.01007721105532064294801323744593686,
      0.05535718154365472209515327785372602,
      27.0 / 560.0)),
    # degree 8
    (((0.03967542307038990126507132953938949,),
      (0.31448780069809631378416056269714830,),
      (0.10198669306270330000000000000000000,),
      (0.18420369694919151227594641734890918,),
      (-0.06343628775453989240514123870189827,),
      (0.02169016206772800480266248262493018,
       0.71993192203946593588943495335273478),
      (0.20448008063679571424133557487274534,
       0.58057719012880922417539817139062041)),
     (0.00639714777990232132145142033517302,
      0.04019044802096617248816115847981783,
      0.02430797550477032117486910877192260,
      0.05485889241369744046692412399039144,
      0.03571961223409918246495096899661762,
      0.00718319069785253940945110521980376,
      0.01637218194531911754093813975611913)),
)


def _degree_slot(itg_order: int) -> int:
    if itg_order <= 5:
        return 0
    if itg_order <= 6:
        return 1
    if itg_order <= 8:
        return 2
    raise ValueError("simplex rules available up to degree 8")


def _triangle_bary(itg_order: int):
    orbits, weights = _TRI_ORBITS[_degree_slot(itg_order)]
    pts, wts = [], []
    for pos, w in zip(orbits, weights):
        if len(pos) == 0:
            pts.append((1 / 3, 1 / 3, 1 / 3))
            wts.append(w)
        elif len(pos) == 1:
            a = pos[0]
            for i in range(3):
                p = [a, a, a]
                p[i] = 1 - 2 * a
                pts.append(tuple(p))
                wts.append(w)
        else:
            a, b = pos
            c = 1.0 - a - b
            src = (a, b, c)
            for i, j in itertools.product(range(3), repeat=2):
                if i == j:
                    continue
                k = 3 - i - j
                pts.append((src[i], src[j], src[k]))
                wts.append(w)
    return pts, wts


def triangle_domain(itg_order: int):
    """(pos[nq, 2], weight[nq]) on the unit triangle (area 1/2)."""
    pts, wts = _triangle_bary(itg_order)
    pos = np.asarray([[p[1], p[2]] for p in pts])
    return pos, np.asarray(wts) / 2.0


def triangle_boundary(itg_order: int):
    """3 edge rules: edge1 (0,0)->(1,0), edge2 (1,0)->(0,1) (len sqrt2),
    edge3 (0,1)->(0,0).  Tangents oriented so outward = rot(t, -90°)."""
    x, w = gauss_1d(itg_order)
    nq = len(x)
    ends = [((0.0, 0.0), (1.0, 0.0)), ((1.0, 0.0), (0.0, 1.0)),
            ((0.0, 1.0), (0.0, 0.0))]
    faces = []
    for (p0, p1) in ends:
        pos = np.outer(1 - x, p0) + np.outer(x, p1)
        d = np.asarray(p1) - np.asarray(p0)
        length = float(np.linalg.norm(d))
        tan = np.broadcast_to((d / length).reshape(1, 2, 1), (nq, 2, 1)).copy()
        faces.append((pos, w * length, tan))
    return faces


def _tet_bary(itg_order: int):
    orbits, weights = _TET_ORBITS[_degree_slot(itg_order)]
    pts, wts = [], []
    for pos, w in zip(orbits, weights):
        if len(pos) == 0:
            pts.append((0.25,) * 4)
            wts.append(w)
        elif len(pos) == 1:
            a = pos[0]
            if a >= 0:  # 3+1 orbit
                for i in range(4):
                    p = [a] * 4
                    p[i] = 1 - 3 * a
                    pts.append(tuple(p))
                    wts.append(w)
            else:  # 2+2 orbit
                b = -a
                for i, j in itertools.combinations(range(4), 2):
                    p = [b] * 4
                    p[i] = 0.5 - b
                    p[j] = 0.5 - b
                    pts.append(tuple(p))
                    wts.append(w)
        elif len(pos) == 2:  # (a, a, b, c) orbit
            a, b = pos
            c = 1 - 2 * a - b
            for i, j in itertools.product(range(4), repeat=2):
                if i == j:
                    continue
                p = [a] * 4
                p[i] = b
                p[j] = c
                pts.append(tuple(p))
                wts.append(w)
        else:  # full permutation of (a, b, c, d)
            d0 = 1.0 - sum(pos)
            src = (*pos, d0)
            for perm in itertools.permutations(range(4), 3):
                i, j, k = perm
                m = 6 - i - j - k
                arr = [0.0] * 4
                arr[0], arr[1], arr[2], arr[3] = src[i], src[j], src[k], src[m]
                pts.append(tuple(arr))
                wts.append(w)
    return pts, wts


def tet_domain(itg_order: int):
    pts, wts = _tet_bary(itg_order)
    pos = np.asarray([[p[1], p[2], p[3]] for p in pts])
    return pos, np.asarray(wts) / 6.0


def tet_boundary(itg_order: int):
    """4 face rules (triangle points mapped onto each face).  Faces:
    1: z=0 (v1,v2,v3), 2: y=0 (v1,v2,v4), 3: slant (v4,v2,v3), 4: x=0
    (v1,v3,v4).  Tangents oriented for outward normals."""
    bpts, bwts = _triangle_bary(itg_order)
    bwts = np.asarray(bwts) / 2.0
    nq = len(bwts)
    corners = [
        ((0, 0, 0), (0, 1, 0), (1, 0, 0)),  # z=0, outward (0,0,-1)
        ((0, 0, 0), (1, 0, 0), (0, 0, 1)),  # y=0, outward (0,-1,0)
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),  # slant, outward (1,1,1)/sqrt3
        ((0, 0, 0), (0, 0, 1), (0, 1, 0)),  # x=0, outward (-1,0,0)
    ]
    faces = []
    for (c0, c1, c2) in corners:
        c0, c1, c2 = map(np.asarray, (c0, c1, c2))
        pos = np.zeros((nq, 3))
        for q, p in enumerate(bpts):
            pos[q] = p[0] * c0 + p[1] * c1 + p[2] * c2
        t1 = (c1 - c0).astype(float)
        t2 = (c2 - c0).astype(float)
        tang = np.zeros((nq, 3, 2))
        tang[:, :, 0] = t1
        tang[:, :, 1] = t2
        # weights are unit-triangle weights; the |J t1 x J t2| surface det
        # computed at update time carries the face area scaling
        faces.append((pos, bwts.copy(), tang))
    return faces
