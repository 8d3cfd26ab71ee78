"""Host-side matrix construction mirroring the reference's ``MatBuild``.

(ref: totsu/src/matbuild/mod.rs:16-333). Two storages:

* ``General(nr, nc)`` — dense, column-major semantics for iterators
* ``SymPack(n)``      — upper triangle packed column-major

This is a *construction* convenience (plain numpy, mutable, host-side);
``to_array()`` hands a CPU tensor to the problem reductions.
"""

from typing import Callable, Iterable

import numpy as np
import torch

from totsu_tpu_torch.ops import sympack


class MatBuild:
    """Mutable matrix (ref MatBuild, matbuild/mod.rs:16-273)."""

    def __init__(self, storage: str, *dims, dtype=np.float64):
        if storage == "general":
            nr, nc = dims
            self._typ = ("general", nr, nc)
            self._arr = np.zeros(nr * nc, dtype=dtype)
        elif storage == "sympack":
            (n,) = dims
            self._typ = ("sympack", n, n)
            self._arr = np.zeros(sympack.tri_len(n), dtype=dtype)
        else:
            raise ValueError(f"unknown storage {storage!r}")

    @classmethod
    def general(cls, nr: int, nc: int, dtype=np.float64) -> "MatBuild":
        return cls("general", nr, nc, dtype=dtype)

    @classmethod
    def sympack(cls, n: int, dtype=np.float64) -> "MatBuild":
        return cls("sympack", n, dtype=dtype)

    @property
    def size(self):
        return (self._typ[1], self._typ[2])

    @property
    def is_sympack(self) -> bool:
        return self._typ[0] == "sympack"

    def _index(self, r: int, c: int) -> int:
        kind, nr, nc = self._typ
        if kind == "general":
            assert 0 <= r < nr and 0 <= c < nc
            return c * nr + r
        if r > c:
            r, c = c, r
        assert c < nc
        return c * (c + 1) // 2 + r

    def __getitem__(self, rc):
        return self._arr[self._index(*rc)]

    def __setitem__(self, rc, val):
        self._arr[self._index(*rc)] = val

    # --- construction API (ref matbuild/mod.rs:68-247) ---

    def set_by_fn(self, fn: Callable[[int, int], float]) -> "MatBuild":
        """Fill every (r, c) of the full grid (ref matbuild/mod.rs:68-94;
        for SymPack, mirror cells are simply written twice)."""
        _, nr, nc = self._typ
        for c in range(nc):
            for r in range(nr):
                self[r, c] = fn(r, c)
        return self

    def set_iter_colmaj(self, it: Iterable[float]) -> "MatBuild":
        """Consume one value per full-grid cell in column-major order,
        stopping early if the iterator runs dry (ref matbuild/mod.rs:99-123)."""
        vals = iter(it)
        _, nr, nc = self._typ
        for c in range(nc):
            for r in range(nr):
                v = next(vals, None)
                if v is None:
                    return self
                self[r, c] = v
        return self

    def set_iter_rowmaj(self, it: Iterable[float]) -> "MatBuild":
        """Row-major variant of :meth:`set_iter_colmaj`
        (ref matbuild/mod.rs:126-150)."""
        vals = iter(it)
        _, nr, nc = self._typ
        for r in range(nr):
            for c in range(nc):
                v = next(vals, None)
                if v is None:
                    return self
                self[r, c] = v
        return self

    def set_scale(self, alpha: float) -> "MatBuild":
        self._arr *= alpha
        return self

    def set_scale_nondiag(self, alpha: float) -> "MatBuild":
        """Scale all off-diagonal entries (ref matbuild/mod.rs:170-201)."""
        kind, nr, nc = self._typ
        if kind == "general":
            for c in range(nc):
                for r in range(nr):
                    if r != c:
                        self[r, c] *= alpha
        else:
            for c in range(nc):
                for r in range(c):
                    self[r, c] *= alpha
        return self

    def set_reshape_colvec(self) -> "MatBuild":
        """Reinterpret the raw storage as a one-column matrix
        (ref matbuild/mod.rs:204-214)."""
        self._typ = ("general", self._arr.size, 1)
        return self

    def set_sqrt(self, eps_zero: float = 0.0) -> "MatBuild":
        """P -> P^(1/2) for SymPack storage via eigendecomposition, keeping
        e > 0 only (ref matbuild/mod.rs:220-247)."""
        del eps_zero  # eigenvalues <= 0 are dropped exactly
        if not self.is_sympack:
            raise ValueError("set_sqrt requires SymPack storage")
        n = self.size[0]
        dense = sympack.unpack(torch.from_numpy(self._arr), n, scaled=False)
        self._arr = sympack.pack(sympack.psd_sqrt(dense), scaled=False).numpy()
        return self

    # --- export ---

    def to_dense(self) -> np.ndarray:
        """Dense (nr, nc) numpy view of the matrix (literal values)."""
        kind, nr, nc = self._typ
        if kind == "general":
            return self._arr.reshape(nc, nr).T.copy()
        return sympack.unpack(torch.from_numpy(self._arr), nr,
                              scaled=False).numpy()

    def to_array(self) -> torch.Tensor:
        """Dense CPU tensor."""
        return torch.from_numpy(self.to_dense())

    def to_packed(self) -> np.ndarray:
        """Raw packed storage (SymPack) or colmaj storage (General)."""
        return self._arr.copy()

    def __repr__(self):
        kind, nr, nc = self._typ
        return f"MatBuild({kind}, {nr}x{nc})\n{self.to_dense()}"

    def __str__(self):
        """Reference Display format (ref matbuild/ex.rs:5-60)."""
        kind, nr, nc = self._typ
        if nr == 0 or nc == 0:
            return "[ ]"
        d = self.to_dense()
        lines = []
        for r in range(nr):
            prefix = "[" if r == 0 else " "
            lines.append(prefix + "".join(f" {d[r, c]:.3e}"
                                          for c in range(nc)))
        label = "General" if kind == "general" else "Symmetric Packed"
        lines[-1] += f" ] ({nr} x {nc}) {label}"
        return "\n".join(lines)
