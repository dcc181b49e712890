"""Irreducible-representation (irreps) bookkeeping for O(3).

A from-scratch re-derivation of the irreps type system the reference
framework gets from e3nn (`e3nn.o3.Irreps`; used throughout the
reference's `matten` package, e.g. data/irreps.py:17). Pure Python,
hashable, static. This is the port's copy of `matten_tpu/ops/irreps.py`.

Conventions (shared by the whole framework):
  * An irrep of O(3) is labeled (l, p): degree l >= 0 and parity p in {+1,-1},
    written "0e", "1o", "2e", ... ; its dimension is 2l+1.
  * `Irreps` is an ordered sum of (mul, Irrep) pairs, written
    "32x0e+16x1o"; the data layout of an array with these irreps is the
    concatenation over entries of `mul` consecutive blocks of size 2l+1
    (channel-major within an entry: [mul, 2l+1] flattened).
  * Sort order of irreps: by (l, then natural parity (-1)**l first):
    0e < 0o < 1o < 1e < 2e < 2o < ...  (matches the ordering the reference
    relies on when sorting tensor-product outputs, nn/utils.py:225).
"""

from __future__ import annotations

import itertools
import re
from typing import Iterator, List, NamedTuple, Sequence, Tuple, Union


class Irrep(NamedTuple):
    """A single irreducible representation of O(3)."""

    l: int
    p: int

    @classmethod
    def make(cls, ir: Union["Irrep", str, Tuple[int, int]]) -> "Irrep":
        if isinstance(ir, Irrep):
            return ir
        if isinstance(ir, str):
            s = ir.strip()
            m = re.fullmatch(r"(\d+)([eo])", s)
            if not m:
                raise ValueError(f"cannot parse irrep {ir!r}")
            return cls(int(m.group(1)), 1 if m.group(2) == "e" else -1)
        if isinstance(ir, tuple) and len(ir) == 2:
            l, p = ir
            if p not in (1, -1) or l < 0:
                raise ValueError(f"invalid irrep {ir!r}")
            return cls(int(l), int(p))
        raise ValueError(f"cannot parse irrep {ir!r}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __str__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __repr__(self) -> str:
        return str(self)

    # sort key: 0e < 0o < 1o < 1e < 2e < 2o < 3o < 3e ...
    def _key(self) -> Tuple[int, int]:
        return (self.l, -self.p * (-1) ** self.l)

    def __lt__(self, other) -> bool:  # type: ignore[override]
        return self._key() < Irrep.make(other)._key()

    def __gt__(self, other) -> bool:  # type: ignore[override]
        return self._key() > Irrep.make(other)._key()

    def __le__(self, other) -> bool:  # type: ignore[override]
        return self._key() <= Irrep.make(other)._key()

    def __ge__(self, other) -> bool:  # type: ignore[override]
        return self._key() >= Irrep.make(other)._key()

    def __mul__(self, other) -> List["Irrep"]:  # type: ignore[override]
        """Selection rule: l in |l1-l2|..l1+l2, p = p1*p2."""
        other = Irrep.make(other)
        p = self.p * other.p
        return [
            Irrep(l, p)
            for l in range(abs(self.l - other.l), self.l + other.l + 1)
        ]


class MulIrrep(NamedTuple):
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __str__(self) -> str:
        return f"{self.mul}x{self.ir}" if self.mul != 1 else str(self.ir)

    def __repr__(self) -> str:
        return str(self)


IrrepsLike = Union["Irreps", str, Irrep, Sequence]


class Irreps(tuple):
    """An ordered direct sum of irreps with multiplicities.

    Immutable and hashable (a tuple of MulIrrep). Replaces e3nn.o3.Irreps
    for this framework (reference usage: data/irreps.py, nn/*).
    """

    def __new__(cls, irreps: IrrepsLike = None):
        if irreps is None:
            return super().__new__(cls, ())
        if isinstance(irreps, Irreps):
            return irreps
        out: List[MulIrrep] = []
        if isinstance(irreps, Irrep):
            out.append(MulIrrep(1, irreps))
        elif isinstance(irreps, str):
            s = irreps.strip()
            if s:
                for term in s.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        out.append(MulIrrep(int(mul_s.strip()), Irrep.make(ir_s)))
                    else:
                        out.append(MulIrrep(1, Irrep.make(term)))
        else:
            for entry in irreps:
                if isinstance(entry, MulIrrep):
                    out.append(entry)
                elif isinstance(entry, Irrep):
                    out.append(MulIrrep(1, entry))
                elif isinstance(entry, str):
                    out.extend(Irreps(entry))
                else:
                    mul, ir = entry
                    out.append(MulIrrep(int(mul), Irrep.make(ir)))
        for mi in out:
            if mi.mul < 0:
                raise ValueError(f"negative multiplicity in {irreps!r}")
        return super().__new__(cls, out)

    # ---- basic properties -------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        """Total multiplicity (number of irrep copies)."""
        return sum(mi.mul for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    @property
    def lmax(self) -> int:
        if not self:
            raise ValueError("empty irreps has no lmax")
        return max(mi.ir.l for mi in self)

    def slices(self) -> List[slice]:
        """Per-entry slices into the flattened feature axis."""
        out = []
        i = 0
        for mi in self:
            out.append(slice(i, i + mi.dim))
            i += mi.dim
        return out

    def count(self, ir) -> int:  # type: ignore[override]
        ir = Irrep.make(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, ir) -> bool:  # type: ignore[override]
        try:
            ir = Irrep.make(ir)
        except (ValueError, TypeError):
            return super().__contains__(ir)
        return any(mi.ir == ir and mi.mul > 0 for mi in self)

    # ---- algebra ----------------------------------------------------------
    def __add__(self, other) -> "Irreps":  # type: ignore[override]
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __radd__(self, other) -> "Irreps":
        return Irreps(tuple(Irreps(other)) + tuple(self))

    def __mul__(self, n: int) -> "Irreps":  # type: ignore[override]
        return Irreps(tuple(self) * n)

    def sort(self) -> Tuple["Irreps", List[int], List[int]]:
        """Stable sort by irrep order.

        Returns (sorted_irreps, permutation, inverse) where
        ``sorted[permutation[i]] == self[i]`` (same convention as the
        e3nn API used at reference nn/utils.py:225-232: `p[old] = new`).
        """
        order = sorted(range(len(self)), key=lambda i: (self[i].ir._key(), i))
        perm = [0] * len(self)
        for new, old in enumerate(order):
            perm[old] = new
        inv = order
        return Irreps([self[i] for i in order]), perm, inv

    def simplify(self) -> "Irreps":
        """Merge adjacent entries with the same irrep; drop zero multiplicities."""
        out: List[MulIrrep] = []
        for mi in self:
            if mi.mul == 0:
                continue
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            else:
                out.append(mi)
        return Irreps(out)

    def regroup(self) -> "Irreps":
        return self.sort()[0].simplify()

    def filter(self, keep) -> "Irreps":
        keep_set = {Irrep.make(ir) for ir in keep}
        return Irreps([mi for mi in self if mi.ir in keep_set])

    # ---- display ----------------------------------------------------------
    def __repr__(self) -> str:
        return "+".join(str(mi) for mi in self) if self else "(empty)"

    __str__ = __repr__

    # ---- constructors -----------------------------------------------------
    @classmethod
    def spherical_harmonics(cls, lmax: int, p: int = -1) -> "Irreps":
        """0e + 1o + 2e + ... (p=-1: natural vector parity)."""
        return cls([(1, Irrep(l, p**l)) for l in range(lmax + 1)])


def tp_path_exists(irreps_in1: IrrepsLike, irreps_in2: IrrepsLike, ir_out) -> bool:
    """Whether ir_out can be produced by some tensor product path.

    Mirrors the behavior of the reference helper (nn/_nequip.py:17-39).
    """
    irreps_in1 = Irreps(irreps_in1).simplify()
    irreps_in2 = Irreps(irreps_in2).simplify()
    ir_out = Irrep.make(ir_out)
    for (_, ir1), (_, ir2) in itertools.product(irreps_in1, irreps_in2):
        if ir_out in ir1 * ir2:
            return True
    return False
