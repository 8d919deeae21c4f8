"""What the cohort drivers share: the traffic's phantoms written as subject
inputs, a closed loop that hands one subject at a time to the program
until the window's time is up, and the seeded sample the reference
checks.

A traffic file (``benchmark/traffic/<name>.json``) gives the sequence
name, the shapes (each ``per_shape`` times), the phantom geometry, the
voxel size, the frame interval and the affine.  The seed gives each
phantom's noise, the order in which the loop cycles through them (in
blocks that hold each shape once) and, where the traffic asks for one, a
pulse-pressure table; every seed has the same set of shapes.  Each pass of the loop is a subject directory of
its own whose input is a link to its phantom's file, so every output the
window wrote is still there when the reference judges it.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


from benchmark.harness import phantoms

FIRST_EID = 3000000


@dataclass
class Pass:
    """One subject handed to the program in the window."""
    k: int
    name: str
    phantom: int
    ok: bool
    error: Optional[str]
    stages: Dict[str, float]
    t_end: float
    outputs: dict = field(default_factory=dict)


class Cohort:
    def __init__(self, traffic: dict, seed: int, workdir: str):
        self.traffic = traffic
        self.seq = traffic["seq"]
        self.shapes = [tuple(s) for s in traffic["shapes"]]
        self.phantoms = [s for s in self.shapes
                         for _ in range(traffic["per_shape"])]
        n, per = len(self.phantoms), traffic["per_shape"]
        self.rngs = phantoms.subject_rngs(seed, n, stream=0)
        # blocks of one phantom of each shape, the shapes in a seeded order
        # in each block and each shape's phantoms in a seeded order over
        # the blocks: any stretch of the loop holds every shape alike
        g = phantoms.seeded_generator(seed, 1)
        own = [g.permutation(per) for _ in self.shapes]
        self.order = [int(s * per + own[s][b]) for b in range(per)
                      for s in g.permutation(len(self.shapes))]
        self.pressures = None
        if "pulse_pressure" in traffic:
            lo, hi = traffic["pulse_pressure"]
            self.pressures = phantoms.seeded_generator(seed, 2).uniform(
                lo, hi, size=n)
        self.inputs = os.path.join(workdir, "inputs")
        self.root = os.path.join(workdir, "subjects")
        self.warm_root = os.path.join(workdir, "warmup")
        for d in (self.inputs, self.root, self.warm_root):
            os.makedirs(d, exist_ok=True)

    def input_path(self, p: int) -> str:
        return os.path.join(self.inputs, f"{p:02d}", f"{self.seq}.nii.gz")

    def write_inputs(self) -> None:
        """Write every phantom's cine, a thread per core (gzip and most of
        numpy's work release the interpreter lock)."""
        threads = min(8, os.cpu_count() or 1)
        t = self.traffic

        def one(p):
            image, _ = phantoms.make_phantom(t, self.phantoms[p],
                                             self.rngs[p])
            os.makedirs(os.path.dirname(self.input_path(p)), exist_ok=True)
            phantoms.save_nifti(self.input_path(p), image, t["affine"],
                                t["pixdim"], t["dt"])

        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(one, range(len(self.phantoms))))
        # write the pages back now, not during the window
        os.sync()

    def pass_phantom(self, k: int) -> int:
        return self.order[k % len(self.order)]

    def _link(self, root: str, name: str, p: int) -> str:
        d = os.path.join(root, name)
        os.makedirs(d)
        os.symlink(self.input_path(p), os.path.join(d, f"{self.seq}.nii.gz"))
        return d

    def new_pass(self, k: int):
        name = str(FIRST_EID + k)
        p = self.pass_phantom(k)
        return name, p, self._link(self.root, name, p)

    def warm_dirs(self) -> List[str]:
        """A subject of each shape, first in the order, to warm up on."""
        seen, out = set(), []
        for p in self.order:
            if self.phantoms[p] not in seen:
                seen.add(self.phantoms[p])
                name = str(FIRST_EID - 1 - len(out))
                out.append((name, p, self._link(self.warm_root, name, p)))
        return out

    def pressure_of(self, names_to_phantom: Dict[str, int]):
        """The pulse pressure of each subject (by eid) or None."""
        if self.pressures is None:
            return None
        import pandas as pd
        return pd.Series({int(n): float(self.pressures[p])
                          for n, p in names_to_phantom.items()})

    def sample(self, passes: List[Pass], seed: int) -> List[int]:
        """The phantoms the reference checks, drawn from the seed among
        those that passed in the window: one of each shape (so the largest
        is always in), then more up to the traffic's ``sample``."""
        rng = phantoms.seeded_generator(seed, 3)
        done = sorted({ps.phantom for ps in passes if ps.ok})
        out = []
        for shape in self.shapes:
            cands = [p for p in done if self.phantoms[p] == shape]
            if cands:
                out.append(cands[int(rng.integers(len(cands)))])
        rest = [p for p in done if p not in out]
        extra = min(self.traffic.get("sample", 0) - len(out), len(rest))
        if extra > 0:
            out += [int(p) for p in rng.choice(rest, extra, replace=False)]
        return out


def closed_loop(cohort: Cohort, seconds: float,
                process: Callable[[str, int, str], Pass]) -> List[Pass]:
    """Hand the program one subject at a time until ``seconds`` have
    passed since the first; the subject running then finishes and counts.
    ``process(name, phantom, dir)`` returns the subject's :class:`Pass`
    with its end time left to this loop."""
    passes: List[Pass] = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        name, p, d = cohort.new_pass(k)
        ps = process(name, p, d)
        ps.k, ps.t_end = k, time.perf_counter() - t0
        passes.append(ps)
        k += 1
    return passes
