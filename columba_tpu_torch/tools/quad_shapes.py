"""The colMin register counts W that the shipped schemes' schedules give
at band radii 8-13: the shapes kernel B's quad body must take
(``csrc/band_step_wide.cuh``, ``search/executor.py`` ``QUAD_MAX_W``).

Run from the repository root on any machine (CPU only, no card):

    python -m columba_tpu_torch.tools.quad_shapes [--lengths 160-270]

For every ``-S`` name of the CLI, each scheme folder under ``schemes/``,
each k in 8..13 the family defines, and each scheme and its mirror, it
compiles the edit-distance schedule (``compile_schedule``) at every read
length in the range, with the uniform partition and, where the folder
gives one, its static partition, and prints the W values at each radius
with the schemes and lengths that give them. It exits 1 if a W exceeds
``QUAD_MAX_W`` at its radius (a shape the quad body does not take). About
18 minutes over 160-270 on one core, most of it loading and checking the
k = 11-13 schemes.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

NAMES = ("kuch1", "kuch2", "kianfar", "01*0", "pigeon", "manbest",
         "suffix_filter", "minU", "columba", "naive")


def shapes(lengths, kbs=range(8, 14)) -> dict:
    """{(kb, W): [(scheme, m, variant, partition), ...]} over the shipped
    schemes at read lengths ``lengths``."""
    from columba_tpu_torch.search import schedule
    from columba_tpu_torch.search.scheme import _SCHEME_DIR, get_scheme

    folders = sorted(os.path.join(_SCHEME_DIR, d)
                     for d in os.listdir(_SCHEME_DIR)
                     if os.path.isdir(os.path.join(_SCHEME_DIR, d)))
    found = collections.defaultdict(list)
    for name in (*NAMES, *folders):
        for k in kbs:
            try:
                base = get_scheme(name, k)
            except (ValueError, OSError, KeyError):
                continue                 # the family stops below k
            for variant, sch in (("as is", base), ("mirror", base.mirrored())):
                for m in lengths:
                    parts = [("uniform", None)]
                    if sch.static_fracs:
                        parts.append(("static", schedule.static_partition(
                            m, sch.static_fracs)))
                    for pname, pts in parts:
                        try:
                            sd = schedule.compile_schedule(sch, m,
                                                           partition=pts)
                        except ValueError:
                            continue     # parts too short at this length
                        found[(sd.kb, sd.W)].append(
                            (os.path.basename(name), m, variant, pname))
    return found


def main(argv=None) -> int:
    from columba_tpu_torch.search.executor import QUAD_MAX_W

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lengths", default="160-270",
                    help="read lengths, lo-hi inclusive")
    args = ap.parse_args(argv)
    lo, hi = (int(x) for x in args.lengths.split("-"))
    found = shapes(range(lo, hi + 1))
    bad = []
    for (kb, W), where in sorted(found.items()):
        names = sorted({w[0] for w in where})
        ms = [w[1] for w in where]
        print(f"kb {kb} W {W}: {len(where)} schedules, m {min(ms)}-{max(ms)}"
              f", {', '.join(names)}")
        if W > QUAD_MAX_W.get(kb, 0):
            bad.append((kb, W))
    print(f"QUAD_MAX_W {QUAD_MAX_W}: "
          + ("every W taken" if not bad else f"not taken: {bad}"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
