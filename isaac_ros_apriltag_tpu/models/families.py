"""Tag family definitions: geometric bit layouts + codeword tables.

Re-design of the reference's family handling. The reference keeps a
string->enum map of nine families (ref: isaac_ros_apriltag/src/apriltag_node.cpp:47-58)
and delegates layouts/codebooks to closed-source backends (cuAprilTags / VPI).
Here a family is pure data: bit-cell coordinates in the border frame plus a
codeword table, so the decoder is one table-driven kernel for every family.

Coordinate convention
---------------------
The *border frame* puts the outer edge of the tag's border square at
``[0, width_at_border] x [0, width_at_border]`` in cell units. This edge is what
the quad detector finds (black/white boundary). Bit cell (bx, by) has its
sampling center at ``(bx + 0.5, by + 0.5)``; coordinates may be negative or
``>= width_at_border`` for families with data bits outside the border
(standard/custom families). Code bit 0 is the MSB, matching the usual AprilTag
code ordering.

Codebooks
---------
tag36h11 / tag16h5 / tag25h9 / tag36h10 codebooks are extracted from OpenCV's
aruco module at generation time (``tools/gen_codebooks.py``) — these are the
real, published AprilTag 3 code tables, so detections interoperate with
physical tags. The five 'flexible layout' families (circleXX/standardXX/
customXX) have no public machine-readable tables in this environment; for them
we generate deterministic codebooks with the family's design Hamming distance
(self-consistent: our renderer + detector round-trip; swap in the official
table via ``register_family`` for physical-tag interop).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@dataclasses.dataclass(frozen=True)
class TagFamily:
    """A tag family as pure data (layout + codebook)."""

    name: str
    nbits: int
    min_hamming: int
    total_width: int        # cells across the printed tag incl. white margin
    width_at_border: int    # cells across the border square (quad boundary)
    reversed_border: bool   # True -> light border inside quad (dark outside)
    bit_x: np.ndarray       # (nbits,) int32 cell coords in border frame
    bit_y: np.ndarray       # (nbits,) int32
    codes: np.ndarray       # (ncodes,) uint64 codewords, bit 0 = MSB
    exact: bool             # True if the codebook matches the published family

    @property
    def ncodes(self) -> int:
        return int(self.codes.shape[0])

    @functools.cached_property
    def rotation_perm(self) -> np.ndarray:
        """(4, nbits) int32: perm[r, i] = index of the bit that lands on
        position i after rotating the tag by r*90 deg CCW.

        Rotating cell coords by 90deg about the border-square center maps
        (x, y) -> (y, wb - 1 - x) in integer cell coordinates.
        """
        wb = self.width_at_border
        coords = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(self.bit_x, self.bit_y))}
        perms = []
        bx, by = self.bit_x.copy(), self.bit_y.copy()
        for _ in range(4):
            perm = np.array([coords[(int(x), int(y))] for x, y in zip(bx, by)], np.int32)
            perms.append(perm)
            bx, by = by.copy(), (wb - 1 - bx).copy()
        out = np.stack(perms)
        for r in range(4):
            assert np.array_equal(np.sort(out[r]), np.arange(self.nbits)), "layout not 90deg-rotation closed"
        return out

    def rotate_code(self, code: int, r: int) -> int:
        """Rotate a codeword by r*90 degrees."""
        perm = self.rotation_perm[r % 4]
        n = self.nbits
        bits = [(code >> (n - 1 - i)) & 1 for i in range(n)]
        out = 0
        for i in range(n):
            out = (out << 1) | bits[perm[i]]
        return out

    def code_grid(self, code: int) -> np.ndarray:
        """Render a codeword into a (total, total) {0,1} bitmap (1 = white).

        Normal families: white margin, black border ring, data bits inside
        (bit set = white). Reversed-border families: dark surround, white
        border ring, data bits per code.
        """
        tw, wb = self.total_width, self.width_at_border
        off = (tw - wb) // 2  # margin cells on each side
        img = np.zeros((tw, tw), np.uint8)
        if not self.reversed_border:
            img[:, :] = 1                                     # white margin
            img[off:off + wb, off:off + wb] = 0               # black border square
            img[off + 1:off + wb - 1, off + 1:off + wb - 1] = 1  # inside default white
        else:
            img[:, :] = 0                                     # dark surround
            img[off:off + wb, off:off + wb] = 1               # light border square
            img[off + 1:off + wb - 1, off + 1:off + wb - 1] = 0
        n = self.nbits
        for i in range(n):
            bit = (code >> (n - 1 - i)) & 1
            x = int(self.bit_x[i]) + off
            y = int(self.bit_y[i]) + off
            img[y, x] = bit
        return img


def _ring_coords(lo: int, hi: int) -> list[tuple[int, int]]:
    """Cells of the square ring with corners (lo,lo)..(hi,hi) inclusive."""
    out = []
    for x in range(lo, hi + 1):
        out.append((x, lo))
    for y in range(lo + 1, hi + 1):
        out.append((hi, y))
    for x in range(hi - 1, lo - 1, -1):
        out.append((x, hi))
    for y in range(hi - 1, lo, -1):
        out.append((lo, y))
    return out


def _grid_coords(lo: int, hi: int, skip: list[tuple[int, int]] = ()) -> list[tuple[int, int]]:
    skip = set(skip)
    return [(x, y) for y in range(lo, hi + 1) for x in range(lo, hi + 1) if (x, y) not in skip]


def _layout(name: str) -> tuple[int, int, bool, np.ndarray, np.ndarray]:
    """Return (total_width, width_at_border, reversed_border, bit_x, bit_y)."""
    if name in ("tag36h11", "tag36h10"):
        # 6x6 data, 1-cell black border (outer edge 8 wide), 1-cell white margin.
        cells = _grid_coords(1, 6)
        tw, wb, rev = 10, 8, False
    elif name == "tag16h5":
        cells = _grid_coords(1, 4)
        tw, wb, rev = 8, 6, False
    elif name == "tag25h9":
        cells = _grid_coords(1, 5)
        tw, wb, rev = 9, 7, False
    elif name == "tagCircle21h7":
        # 5x5 data minus corners (21 bits) inside a 7-wide border.
        cells = _grid_coords(1, 5, skip=[(1, 1), (5, 1), (1, 5), (5, 5)])
        tw, wb, rev = 9, 7, False
    elif name == "tagCircle49h12":
        # 7x7 data (49 bits) inside a 9-wide border.
        cells = _grid_coords(1, 7)
        tw, wb, rev = 11, 9, False
    elif name == "tagCustom48h12":
        # 7x7 minus center (48 bits) inside a 9-wide light border, dark surround.
        cells = _grid_coords(1, 7, skip=[(4, 4)])
        tw, wb, rev = 11, 9, True
    elif name == "tagStandard41h12":
        # 3x3 inner grid + 32-cell outer ring two cells outside a 5-wide border.
        cells = _grid_coords(1, 3) + _ring_coords(-2, 6)
        tw, wb, rev = 9, 5, True
    elif name == "tagStandard52h13":
        # 4x4 inner grid + 36-cell outer ring two cells outside a 6-wide border.
        cells = _grid_coords(1, 4) + _ring_coords(-2, 7)
        tw, wb, rev = 10, 6, True
    else:
        raise ValueError(f"unknown family layout: {name}")
    bx = np.array([c[0] for c in cells], np.int32)
    by = np.array([c[1] for c in cells], np.int32)
    return tw, wb, rev, bx, by


# (nbits, min_hamming, exact_source) per family. The nine names mirror the
# reference's registry (ref: isaac_ros_apriltag/src/apriltag_node.cpp:47-58).
FAMILY_SPECS = {
    "tag36h11": (36, 11, True),
    "tag36h10": (36, 10, True),
    "tag25h9": (25, 9, True),
    "tag16h5": (16, 5, True),
    "tagCircle21h7": (21, 7, False),
    "tagCircle49h12": (49, 12, False),
    "tagCustom48h12": (48, 12, False),
    "tagStandard41h12": (41, 12, False),
    "tagStandard52h13": (52, 13, False),
}

_REGISTRY: dict[str, TagFamily] = {}


def register_family(fam: TagFamily) -> None:
    _REGISTRY[fam.name] = fam


def family_names() -> list[str]:
    return list(FAMILY_SPECS.keys())


@functools.lru_cache(maxsize=None)
def _load_codebooks() -> dict[str, np.ndarray]:
    path = os.path.join(_DATA_DIR, "codebooks.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — run tools/gen_codebooks.py to generate codeword tables")
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def get_family(name: str) -> TagFamily:
    """Look up a family by name (registry first, then built-in tables)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name not in FAMILY_SPECS:
        raise ValueError(
            f"Invalid tag family {name!r}; expected one of {family_names()}")
    nbits, minh, exact = FAMILY_SPECS[name]
    tw, wb, rev, bx, by = _layout(name)
    assert len(bx) == nbits, (name, len(bx), nbits)
    codes = _load_codebooks()[name].astype(np.uint64)
    fam = TagFamily(name=name, nbits=nbits, min_hamming=minh, total_width=tw,
                    width_at_border=wb, reversed_border=rev, bit_x=bx, bit_y=by,
                    codes=codes, exact=exact)
    register_family(fam)
    return fam
