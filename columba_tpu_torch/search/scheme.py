"""Search-scheme model: π/L/U searches, validation, parsing, registry.

TPU-native re-design of the reference's L3 layer
(reference: src/search.h:116-194 ``Search::makeSearch``,
src/search.h:509-758 ``SearchScheme``): a ``Search`` is the (π, L, U) triple
with derived per-phase directions; a ``SearchScheme`` is the set of searches
for one k. Scheme data files use the reference-compatible text format
(one ``{π} {L} {U}`` line per search; folder layout ``<name>/<k>/
searches.txt``), so the reference's custom scheme folders load unchanged.

Coverage checking ports the offline validity checker
(reference: validitychecker/validitychecker.py:46-227): a scheme is lossless
for Hamming iff every error distribution over parts is covered by >= 1
search; the edit-distance guarantee follows per the underlying papers.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from functools import cached_property

BACKWARD, FORWARD = 0, 1

_SCHEME_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "schemes")


@dataclass(frozen=True)
class Search:
    """One search: part order π, cumulative lower/upper bounds L/U."""

    pi: tuple[int, ...]
    lower: tuple[int, ...]
    upper: tuple[int, ...]

    def __post_init__(self):
        p = len(self.pi)
        if not (len(self.lower) == len(self.upper) == p and p >= 1):
            raise ValueError("pi/L/U must have equal nonzero length")
        if sorted(self.pi) != list(range(p)):
            raise ValueError(f"pi must be a permutation of 0..{p-1}: {self.pi}")
        # connectivity: each next part extends the processed interval
        lo = hi = self.pi[0]
        for x in self.pi[1:]:
            if x == hi + 1:
                hi = x
            elif x == lo - 1:
                lo = x
            else:
                raise ValueError(f"pi not connected: {self.pi}")
        for i in range(1, p):
            if self.lower[i] < self.lower[i - 1] or self.upper[i] < self.upper[i - 1]:
                raise ValueError("L/U must be non-decreasing")
        if any(l > u for l, u in zip(self.lower, self.upper)):
            raise ValueError("L must be <= U")

    @property
    def num_parts(self) -> int:
        return len(self.pi)

    @cached_property
    def directions(self) -> tuple[int, ...]:
        """Per-phase extension direction; phase 0 copies phase 1
        (reference: src/search.h:127-137)."""
        p = len(self.pi)
        if p == 1:
            return (BACKWARD,)
        dirs = [FORWARD if self.pi[1] > self.pi[0] else BACKWARD]
        for i in range(1, p):
            dirs.append(FORWARD if self.pi[i] > self.pi[i - 1] else BACKWARD)
        return tuple(dirs)

    @cached_property
    def part_extent(self) -> tuple[tuple[int, int], ...]:
        """(lowest, highest) part processed after each phase."""
        lo = hi = self.pi[0]
        out = [(lo, hi)]
        for x in self.pi[1:]:
            lo, hi = min(lo, x), max(hi, x)
            out.append((lo, hi))
        return tuple(out)

    @cached_property
    def num_exact_prefix_phases(self) -> int:
        """Number of leading phases with U == 0 (matched exactly)."""
        c = 0
        for u in self.upper:
            if u == 0:
                c += 1
            else:
                break
        return c

    def covers(self, distribution: tuple[int, ...]) -> bool:
        """Does this search cover the given per-part error distribution?
        (reference: src/search.h:452-463 ``coversDistribution``)"""
        cum = 0
        for i, part in enumerate(self.pi):
            cum += distribution[part]
            if not (self.lower[i] <= cum <= self.upper[i]):
                return False
        return True

    @property
    def max_errors(self) -> int:
        return self.upper[-1]

    def __str__(self):
        fmt = lambda v: "{" + ",".join(map(str, v)) + "}"
        return f"{fmt(self.pi)} {fmt(self.lower)} {fmt(self.upper)}"


@dataclass(frozen=True)
class SearchScheme:
    """All searches of one scheme for a single k."""

    searches: tuple[Search, ...]
    k: int
    name: str = "custom"
    # optional per-scheme partitioning data (reference custom-folder files
    # static_partitioning.txt / dynamic_partitioning.txt)
    static_fracs: tuple[float, ...] | None = None
    seed_fracs: tuple[float, ...] | None = None
    weights: tuple[int, ...] | None = None

    def __post_init__(self):
        if not self.searches:
            raise ValueError("empty scheme")
        p = self.searches[0].num_parts
        for s in self.searches:
            if s.num_parts != p:
                raise ValueError("all searches must have equal #parts")
            if s.max_errors > self.k:
                raise ValueError(f"search exceeds k={self.k}: {s}")

    @property
    def num_parts(self) -> int:
        return self.searches[0].num_parts

    def uncovered_distributions(self) -> list[tuple[int, ...]]:
        """All error distributions summing to <= k not covered by any search
        (empty iff the scheme is lossless for Hamming distance).

        Enumerates only the C(p+k, k) distributions with sum <= k
        (the reference's checker does the same,
        validitychecker/validitychecker.py:46-67)."""
        p = self.num_parts
        bad = []

        def rec(prefix, remaining):
            if len(prefix) == p - 1:
                for last in range(remaining + 1):
                    dist = (*prefix, last)
                    if not any(s.covers(dist) for s in self.searches):
                        bad.append(dist)
                return
            for v in range(remaining + 1):
                rec((*prefix, v), remaining - v)

        rec((), self.k)
        return bad

    def is_valid(self) -> bool:
        return not self.uncovered_distributions()

    def __str__(self):
        return "\n".join(str(s) for s in self.searches)


def parse_search_line(line: str) -> Search:
    """Parse '{0,1,2} {0,0,0} {0,2,2}'."""
    parts = line.replace("{", " ").replace("}", " ").split()
    if len(parts) != 3:
        raise ValueError(f"bad search line: {line!r}")
    vals = [tuple(int(x) for x in p.split(",")) for p in parts]
    return Search(*vals)


def parse_scheme_text(text: str, k: int, name: str = "custom") -> SearchScheme:
    searches = [
        parse_search_line(line)
        for line in text.splitlines()
        if line.strip()
    ]
    return SearchScheme(tuple(searches), k=k, name=name)


def load_scheme_folder(folder: str, k: int) -> SearchScheme:
    """Load ``<folder>/<k>/searches.txt`` (reference custom-scheme layout,
    further_info/advanced_options/README.md:36-97)."""
    path = os.path.join(folder, str(k), "searches.txt")
    with open(path) as f:
        text = f.read()
    name = "custom"
    name_file = os.path.join(folder, "name.txt")
    if os.path.exists(name_file):
        with open(name_file) as f:
            name = f.read().strip()
    scheme = parse_scheme_text(text, k=k, name=name)
    static_file = os.path.join(folder, str(k), "static_partitioning.txt")
    dyn_file = os.path.join(folder, str(k), "dynamic_partitioning.txt")
    extra = {}
    if os.path.exists(static_file):
        with open(static_file) as f:
            extra["static_fracs"] = tuple(float(x) for x in f.read().split())
    if os.path.exists(dyn_file):
        with open(dyn_file) as f:
            lines = f.read().splitlines()
        if lines and lines[0].strip():
            extra["seed_fracs"] = tuple(float(x) for x in lines[0].split())
        if len(lines) > 1 and lines[1].strip():
            extra["weights"] = tuple(int(x) for x in lines[1].split())
    if extra:
        from dataclasses import replace

        scheme = replace(scheme, **extra)
    if not scheme.is_valid():
        raise ValueError(
            f"scheme {name} k={k} is not lossless; uncovered: "
            f"{scheme.uncovered_distributions()[:5]}"
        )
    return scheme


# ---------------------------------------------------------------------------
# Generators / registry
# ---------------------------------------------------------------------------

def pigeonhole_scheme(k: int) -> SearchScheme:
    """Classic pigeonhole: k+1 parts, each search starts at a distinct exact
    part and fans out with U = k elsewhere."""
    p = k + 1
    searches = []
    for start in range(p):
        if start == 0:
            pi = tuple(range(p))
        elif start == p - 1:
            pi = tuple(range(p - 1, -1, -1))
        else:
            pi = (start,) + tuple(range(start + 1, p)) + tuple(range(start - 1, -1, -1))
        lower = (0,) * p
        upper = (0,) + (k,) * (p - 1)
        searches.append(Search(pi, lower, upper))
    return SearchScheme(tuple(searches), k=k, name="pigeon")


def naive_scheme(k: int) -> SearchScheme:
    """Single-part backward search (naive backtracking)."""
    return SearchScheme((Search((0,), (0,), (k,)),), k=k, name="naive")


def exact_scheme() -> SearchScheme:
    return SearchScheme((Search((0,), (0,), (0,)),), k=0, name="exact")


_BUILTIN_DIRS = {
    "kuch1": "kuch_k+1",
    "kuch2": "kuch_k+2",
    "kianfar": "kianfar",
    "01*0": "01star0",
    "pigeon": "pigeon",
    "manbest": "manbest",
    "suffix_filter": "suffix_filter",
    "minU": "minU",
    "columba": "columba",
}


@functools.lru_cache(maxsize=512)
def get_scheme(name: str, k: int) -> SearchScheme:
    """Scheme registry: builtin generators + bundled data folders + custom
    folder paths (mirrors the reference's -S / -ss options).

    Cached per (name, k): folder load + losslessness validation cost
    ~0.7s for the k=5 dynamic-selection set, and the BEST path resolves
    its scheme per batch — measured as the single largest host cost of
    the reference-default mode before this cache. SearchScheme is treated
    as immutable by every consumer."""
    if k == 0:
        return exact_scheme()
    if name == "naive":
        return naive_scheme(k)
    if name == "pigeon":
        return pigeonhole_scheme(k)
    if name == "columba":
        # minU for k <= 7, greedy pigeonhole-style schemes for 8..13
        # (reference: src/searchstrategy.h ColumbaSearchStrategy)
        if k <= 7:
            return get_scheme("minU", k)
        return load_scheme_folder(os.path.join(_SCHEME_DIR, "columba_greedy"), k)
    folder = _BUILTIN_DIRS.get(name)
    if folder is not None:
        return load_scheme_folder(os.path.join(_SCHEME_DIR, folder), k)
    if os.path.isdir(name):
        return load_scheme_folder(name, k)
    raise ValueError(f"unknown scheme {name!r} (and not a folder)")
