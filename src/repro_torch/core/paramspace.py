"""Parameter combinatorics (paper §5.1).

Every multi-valued parameter contributes a factor to the Cartesian
product; ``fixed`` groups are zipped (bijection) and contribute a single
factor; ``sampling`` selects a subset of the resulting combination space.

The expansion is deterministic: parameters iterate in declaration order,
row-major, with fixed groups hoisted to the outermost loops (matching the
paper's "move fixed parameters into the outermost loop structures").

Because the order is a plain mixed-radix counter over the loop factors,
every combination has an integer address: ``combo_at(i)`` decodes index
``i`` in O(#factors) without enumerating anything, ``index_of(combo)``
is its inverse, and ``iter_sample()`` streams the post-``sampling``
subset as indices — the basis for studies over spaces far too large to
materialize (millions of combinations cost no startup memory).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import random
from typing import Any, Iterator, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class ParameterSpace:
    """A declared parameter space: names → value lists, plus fixed groups."""

    params: dict[str, list[Any]]
    fixed: list[list[str]] = dataclasses.field(default_factory=list)
    sampling: dict[str, Any] | None = None

    def __post_init__(self) -> None:
        if self.sampling:
            method = str(self.sampling.get("method", "uniform")).lower()
            if method not in ("uniform", "random"):
                raise ValueError(f"unknown sampling method {method!r}")
        seen: set[str] = set()
        for group in self.fixed:
            lens = {len(self.params[p]) for p in group}
            if len(lens) > 1:
                raise ValueError(
                    f"fixed group {group} has mismatched lengths "
                    f"{[len(self.params[p]) for p in group]}"
                )
            for p in group:
                if p not in self.params:
                    raise ValueError(f"fixed group references unknown parameter {p!r}")
                if p in seen:
                    raise ValueError(f"parameter {p!r} appears in multiple fixed groups")
                seen.add(p)

    # -- cardinality ----------------------------------------------------
    def size(self) -> int:
        """N_W = ∏ N_i with fixed groups counted once each."""
        n = 1
        grouped = {p for g in self.fixed for p in g}
        for g in self.fixed:
            n *= len(self.params[g[0]])
        for name, values in self.params.items():
            if name not in grouped:
                n *= len(values)
        return n

    # -- enumeration ----------------------------------------------------
    def _factors(self) -> list[tuple[tuple[str, ...], list[tuple[Any, ...]]]]:
        """Ordered loop factors: fixed groups outermost, then free params."""
        factors: list[tuple[tuple[str, ...], list[tuple[Any, ...]]]] = []
        grouped = {p for g in self.fixed for p in g}
        for g in self.fixed:
            cols = [self.params[p] for p in g]
            factors.append((tuple(g), list(zip(*cols))))
        for name, values in self.params.items():
            if name not in grouped:
                factors.append(((name,), [(v,) for v in values]))
        return factors

    def combinations(self) -> Iterator[dict[str, Any]]:
        """Yield every unique parameter combination (one per workflow)."""
        factors = self._factors()
        names: list[str] = [n for grp, _ in factors for n in grp]
        for combo in itertools.product(*(vals for _, vals in factors)):
            flat = tuple(v for tup in combo for v in tup)
            yield dict(zip(names, flat))

    # -- O(1) indexed addressing ----------------------------------------
    @functools.cached_property
    def _addressing(self) -> tuple[list[tuple[tuple[str, ...], list[tuple[Any, ...]]]],
                                   list[str], list[int]]:
        """Cached (factors, flat names, radices) — the mixed-radix digit
        plan shared by ``combo_at`` and ``index_of``."""
        factors = self._factors()
        names = [n for grp, _ in factors for n in grp]
        radices = [len(vals) for _, vals in factors]
        return factors, names, radices

    def combo_at(self, index: int) -> dict[str, Any]:
        """Decode combination ``index`` (row-major mixed radix, matching
        ``combinations()`` order) without enumerating the space."""
        n = self.size()
        if not 0 <= index < n:
            raise IndexError(f"combination index {index} out of range [0, {n})")
        factors, names, radices = self._addressing
        digits: list[int] = [0] * len(radices)
        rem = index
        for pos in range(len(radices) - 1, -1, -1):
            rem, digits[pos] = divmod(rem, radices[pos])
        flat = tuple(v for (_, vals), d in zip(factors, digits)
                     for v in vals[d])
        return dict(zip(names, flat))

    @functools.cached_property
    def _value_index(self) -> list[dict[Any, int] | None]:
        """Per-factor value-tuple → digit maps (``None`` where a value is
        unhashable; ``index_of`` falls back to a linear scan there)."""
        factors, _, _ = self._addressing
        maps: list[dict[Any, int] | None] = []
        for _, vals in factors:
            try:
                maps.append({v: i for i, v in enumerate(vals)})
            except TypeError:
                maps.append(None)
        return maps

    def index_of(self, combo: Mapping[str, Any]) -> int:
        """Inverse of ``combo_at``: the row-major index of ``combo``.
        Raises ``KeyError``/``ValueError`` when the combination does not
        belong to this space."""
        factors, _, _ = self._addressing
        index = 0
        for (group, vals), vmap in zip(factors, self._value_index):
            tup = tuple(combo[p] for p in group)
            if vmap is not None:
                digit = vmap.get(tup)
                if digit is None:
                    raise ValueError(
                        f"combination value {tup!r} for {group} is not in "
                        f"this parameter space")
            else:
                try:
                    digit = vals.index(tup)
                except ValueError:
                    raise ValueError(
                        f"combination value {tup!r} for {group} is not in "
                        f"this parameter space") from None
            index = index * len(vals) + digit
        return index

    def space_hash(self) -> str:
        """Stable short hash of the declared space (params + fixed +
        sampling) — journal v2 uses it to pair a resume with its study."""
        blob = json.dumps(
            {"params": self.params, "fixed": self.fixed,
             "sampling": self.sampling},
            sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- sampling -------------------------------------------------------
    def sample_count(self) -> int:
        """Post-``sampling`` instance count, computed without enumerating
        the combination space."""
        n = self.size()
        if not self.sampling:
            return n
        if "count" in self.sampling:
            k = int(self.sampling["count"])
        elif "fraction" in self.sampling:
            k = max(1, int(round(float(self.sampling["fraction"]) * n)))
        else:
            k = n
        return min(k, n)

    def iter_sample(self, seed: int | None = None) -> Iterator[int]:
        """Stream the post-``sampling`` subset as combination *indices*,
        in deterministic order, without materializing the space.

        ``method: uniform`` strides the index range to reach the
        requested count; ``method: random`` draws indices without
        replacement (O(k) via ``random.sample`` over a lazy ``range``).
        ``count`` (int) or ``fraction`` (0..1] select the subset size.
        """
        n = self.size()
        if not self.sampling:
            yield from range(n)
            return
        method = str(self.sampling.get("method", "uniform")).lower()
        k = self.sample_count()
        if method == "uniform":
            if k == n:
                yield from range(n)
                return
            stride = n / k
            for i in range(k):
                yield int(i * stride)
            return
        if method == "random":
            rng = random.Random(
                self.sampling.get("seed", seed if seed is not None else 0))
            yield from rng.sample(range(n), k)
            return
        raise ValueError(f"unknown sampling method {method!r}")

    def sample(self, seed: int | None = None) -> list[dict[str, Any]]:
        """Apply the ``sampling`` keyword: subset of the combination space
        (materialized; prefer ``iter_sample``/``combo_at`` for large
        spaces)."""
        return [self.combo_at(i) for i in self.iter_sample(seed)]


def combo_id(combo: Mapping[str, Any]) -> str:
    """Stable short identifier for a parameter combination (provenance)."""
    blob = json.dumps({k: combo[k] for k in sorted(combo)}, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def from_task(params: Mapping[str, Sequence[Any]], fixed: Sequence[Sequence[str]],
              sampling: Mapping[str, Any] | None = None) -> ParameterSpace:
    """Build a space from TaskSpec.parameters() output, resolving bare
    fixed names (``size`` → ``args:size``) to full parameter paths."""
    resolved: list[list[str]] = []
    for group in fixed:
        rg: list[str] = []
        for pname in group:
            if pname in params:
                rg.append(pname)
            else:
                matches = [k for k in params if k.endswith(":" + pname)]
                if len(matches) != 1:
                    raise ValueError(f"fixed parameter {pname!r} is unknown/ambiguous")
                rg.append(matches[0])
        resolved.append(rg)
    return ParameterSpace(
        params={k: list(v) for k, v in params.items()},
        fixed=resolved,
        sampling=dict(sampling) if sampling else None,
    )
