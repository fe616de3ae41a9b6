"""Mesh extraction from the TSDF volume (marching tetrahedra).

Port of ``tandem_tpu/mapping/mesh.py`` (the reference's CUDA marching-cubes
extractor, tandem/libdr/dr_fusion/src/marching_cubes/mesh_extractor.cu:
244-265). It runs every ``mesh_extraction_freq`` backend calls, off the
critical path: ``_corner_grids`` samples the (b+1)^3 corner grids of a
chunk of allocated blocks on the device (torch ops), and the
data-dependent triangle assembly, ``_march_tets``, is numpy on the host
(a copy of the JAX package's, which is host numpy too). Six tetrahedra per
cell sharing the main diagonal give a watertight surface at sdf = 0.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .tsdf import TsdfConfig, TsdfVolume, _voxels_at

# 6-tetrahedra decomposition of the unit cell; corner i has coordinates
# ((i>>0)&1, (i>>1)&1, (i>>2)&1); all tets share the 0-7 diagonal.
_TETS = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7],
], np.int32)

_CORNER_OFFSETS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1]
                            for i in range(8)], np.int32)


def _corner_grids(cfg: TsdfConfig, vol: TsdfVolume, slots):
    """Sample the (b+1)^3 corner sdf/weight/colour grids of pool slots.

    :param slots: (C,) int64 pool indices
    :return: sdf (C, b+1, b+1, b+1), weight (...), color (..., 3)
    """
    _corner_grids.calls += 1
    b = cfg.block_size
    n = b + 1
    dev = slots.device
    coords = vol.block_coords[slots]                   # (C, 3)
    r = torch.arange(n, dtype=torch.int32, device=dev)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    local = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    # The JAX package looks up the world points (coords * b + local) *
    # voxel_size through _get_voxels; XLA folds the scale and its division
    # away, so every corner reads exactly its integer voxel, as here.
    vox = (coords[:, None, :] * b + local[None]).reshape(-1, 3)
    C = coords.shape[0]
    sdf, w, col = _voxels_at(cfg, vol, vox,
                             torch.div(vox, b, rounding_mode="floor"))
    return (sdf.reshape(C, n, n, n), w.reshape(C, n, n, n),
            col.reshape(C, n, n, n, 3))


_corner_grids.calls = 0


def extract_mesh(cfg: TsdfConfig, vol: TsdfVolume,
                 chunk: int = 512) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """:return: vertices (N, 3) float32, faces (M, 3) int32, colors (N, 3)
    uint8."""
    n_alloc = int(vol.n_allocated)
    b = cfg.block_size
    dev = vol.block_coords.device
    verts_out, cols_out = [], []
    coords_all = vol.block_coords[:n_alloc].cpu().numpy()

    for start in range(0, n_alloc, chunk):
        count = min(chunk, n_alloc - start)
        slots = torch.arange(start, start + count, device=dev)
        sdf, w, col = (x.cpu().numpy()
                       for x in _corner_grids(cfg, vol, slots))
        coords = coords_all[start:start + count]

        # Cells: (C, b, b, b, 8) corner values
        cs = np.stack([sdf[:, ox:ox + b, oy:oy + b, oz:oz + b]
                       for ox, oy, oz in _CORNER_OFFSETS], -1)
        cw = np.stack([w[:, ox:ox + b, oy:oy + b, oz:oz + b]
                       for ox, oy, oz in _CORNER_OFFSETS], -1)
        cc = np.stack([col[:, ox:ox + b, oy:oy + b, oz:oz + b]
                       for ox, oy, oz in _CORNER_OFFSETS], -2)

        valid = (cw > 0).all(-1)
        sign_change = (cs < 0).any(-1) & (cs >= 0).any(-1)
        sel = np.argwhere(valid & sign_change)  # (M, 4): block, x, y, z
        if sel.shape[0] == 0:
            continue
        bidx = sel[:, 0]
        s8 = cs[sel[:, 0], sel[:, 1], sel[:, 2], sel[:, 3]]
        c8 = cc[sel[:, 0], sel[:, 1], sel[:, 2], sel[:, 3]]
        base = ((coords[bidx] * b + sel[:, 1:]).astype(np.float64)
                * cfg.voxel_size)
        p8 = base[:, None, :] + _CORNER_OFFSETS[None] * cfg.voxel_size
        v, c = _march_tets(s8, p8, c8)
        if v.shape[0]:
            verts_out.append(v.astype(np.float32))
            cols_out.append(c)

    if not verts_out:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.uint8))
    verts = np.concatenate(verts_out)
    cols = np.concatenate(cols_out)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    return verts, faces, cols.astype(np.uint8)


def _edge_points(sm, pm, cm, ia, ib):
    """The sdf zero crossing on the edge (ia, ib) of each tetrahedron and
    its interpolated colour."""
    ar = np.arange(len(sm))
    sa, sb = sm[ar, ia], sm[ar, ib]
    tpar = sa / np.where(np.abs(sa - sb) < 1e-12, 1e-12, sa - sb)
    tpar = np.clip(tpar, 0, 1)[:, None]
    return (pm[ar, ia] + tpar * (pm[ar, ib] - pm[ar, ia]),
            cm[ar, ia] + tpar * (cm[ar, ib] - cm[ar, ia]))


def _march_tets(s8, p8, c8):
    """Triangulate cells via 6 tetrahedra each.

    :param s8: (M, 8) corner sdf; p8: (M, 8, 3) positions; c8: (M, 8, 3)
    :return: flat triangle vertices (3*T, 3) and vertex colours (3*T, 3)
    """
    verts, cols = [], []
    others = np.array([[j for j in range(4) if j != i] for i in range(4)])
    for tet in _TETS:
        s = s8[:, tet]            # (M, 4)
        p = p8[:, tet]            # (M, 4, 3)
        c = c8[:, tet]            # (M, 4, 3)
        neg = s < 0
        count = neg.sum(-1)

        # one corner inside (or three inside -> the complementary corner)
        for k, single_neg in ((1, True), (3, False)):
            m = count == k
            if not m.any():
                continue
            inside = neg if single_neg else ~neg
            a = inside[m].argmax(-1)  # the lone corner
            oth = others[a]           # (K, 3)
            sm, pm, cm = s[m], p[m], c[m]
            vs, cs_ = zip(*(_edge_points(sm, pm, cm, a, oth[:, j])
                            for j in range(3)))
            verts.append(np.stack(vs, 1).reshape(-1, 3))
            cols.append(np.stack(cs_, 1).reshape(-1, 3))

        # two inside: a quad -> 2 triangles
        m = count == 2
        if m.any():
            sm, pm, cm, nm = s[m], p[m], c[m], neg[m]
            order = np.argsort(~nm, axis=1, kind="stable")  # neg first
            A, B, C, D = order[:, 0], order[:, 1], order[:, 2], order[:, 3]
            vac, cac = _edge_points(sm, pm, cm, A, C)
            vad, cad = _edge_points(sm, pm, cm, A, D)
            vbc, cbc = _edge_points(sm, pm, cm, B, C)
            vbd, cbd = _edge_points(sm, pm, cm, B, D)
            # triangles (AC, AD, BC) and (BC, AD, BD)
            verts.append(np.stack([vac, vad, vbc], 1).reshape(-1, 3))
            cols.append(np.stack([cac, cad, cbc], 1).reshape(-1, 3))
            verts.append(np.stack([vbc, vad, vbd], 1).reshape(-1, 3))
            cols.append(np.stack([cbc, cad, cbd], 1).reshape(-1, 3))

    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.concatenate(verts), np.concatenate(cols)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             colors: np.ndarray = None):
    """Write an OBJ with optional per-vertex colours through an atomic
    rename (main_tandem_pangolin.cpp:296-303)."""
    tmp = path + ".incomplete"
    with open(tmp, "w") as f:
        if colors is not None and len(colors) == len(vertices):
            for v, c in zip(vertices, colors):
                f.write(f"v {v[0]} {v[1]} {v[2]} "
                        f"{c[0] / 255:.4f} {c[1] / 255:.4f} {c[2] / 255:.4f}\n")
        else:
            for v in vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
    os.replace(tmp, path)
