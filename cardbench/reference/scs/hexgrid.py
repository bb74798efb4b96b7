# Frozen copy of nuzero_tpu_torch/envs/scs/hexgrid.py for the benchmark's plain reference;
# only its imports were rewritten.  It is never edited to follow the port.
"""Static hex-grid neighbor tables for offset coordinates.

Duplicate of ``nuzero_tpu/envs/scs/hexgrid.py`` (pure NumPy), kept in the
port so that it imports without JAX.

Geometry (ref ``Games/SCS/SCS_Game.py:1199-1243``): columns are vertical;
a tile's diagonal neighbors shift with column parity:

    n = (r-1, c)   s = (r+1, c)
    even c: ne=(r-1,c+1) se=(r,c+1)   sw=(r,c-1)   nw=(r-1,c-1)
    odd  c: ne=(r,c+1)   se=(r+1,c+1) sw=(r+1,c-1) nw=(r,c-1)

Direction order is the reference's clockwise [n, ne, se, s, sw, nw]
(ref ``SCS_Game.py:1245-1247``) — the movement action planes are laid out
in this order (ref ``parse_action``, ``SCS_Game.py:511-528``).
"""

from __future__ import annotations

import numpy as np

DIRECTIONS = ("n", "ne", "se", "s", "sw", "nw")
NUM_DIRECTIONS = 6


def neighbor_tables(rows: int, cols: int):
    """Returns (dst_r, dst_c, valid), each int32/bool of shape [6, R, C].

    ``dst_r/dst_c`` give the destination tile of moving from (r, c) in each
    direction (clipped to the board when invalid); ``valid`` marks moves
    that stay on the board (the boundary rules of ``check_tiles``,
    ref ``SCS_Game.py:1069-1091``).
    """
    r = np.arange(rows)[:, None] * np.ones(cols, np.int64)[None, :]
    c = np.ones(rows, np.int64)[:, None] * np.arange(cols)[None, :]
    r = r.astype(np.int64)
    c = c.astype(np.int64)
    even = (c % 2) == 0

    dst_r = np.zeros((6, rows, cols), np.int64)
    dst_c = np.zeros((6, rows, cols), np.int64)

    dst_r[0], dst_c[0] = r - 1, c  # n
    dst_r[1], dst_c[1] = np.where(even, r - 1, r), c + 1  # ne
    dst_r[2], dst_c[2] = np.where(even, r, r + 1), c + 1  # se
    dst_r[3], dst_c[3] = r + 1, c  # s
    dst_r[4], dst_c[4] = np.where(even, r, r + 1), c - 1  # sw
    dst_r[5], dst_c[5] = np.where(even, r - 1, r), c - 1  # nw

    valid = (
        (dst_r >= 0) & (dst_r < rows) & (dst_c >= 0) & (dst_c < cols)
    )
    dst_r = np.clip(dst_r, 0, rows - 1).astype(np.int32)
    dst_c = np.clip(dst_c, 0, cols - 1).astype(np.int32)
    return dst_r, dst_c, valid
