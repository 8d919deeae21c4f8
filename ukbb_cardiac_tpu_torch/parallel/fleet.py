"""Fleet driver: parallel per-subject processing with failure isolation.

Replaces the reference's manual subject sharding — the user launching
many processes with ``--start_idx/--end_idx`` ranges
(``eval_strain_sax.py:26-34``, SURVEY.md §2.4(b)) — with a single driver
that shards a subject list over workers, isolates failures (the
reference's skip-and-continue semantics, SURVEY.md §5 "failure
detection"), resumes idempotently, and records a structured manifest.

Device-bound stages (segmentation, registration) keep one process per
accelerator; host-bound stages (phenotypes, geometry) fan out over a
thread pool since they release the GIL in numpy/cv2.

The port's copy of ``ukbb_cardiac_tpu/parallel/fleet.py`` (host code).
"""

from __future__ import annotations

import json
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Dict, List, Optional, Sequence


def shard_subjects(subjects: Sequence[str], n_shards: int,
                   shard_id: int) -> List[str]:
    """Deterministic interleaved shard (replaces --start_idx/--end_idx;
    interleaving balances load when subject difficulty drifts with eid)."""
    return list(subjects[shard_id::n_shards])


class FleetResult:
    def __init__(self):
        self.succeeded: List[str] = []
        self.failed: Dict[str, str] = {}
        self.skipped: List[str] = []
        self.seconds: Dict[str, float] = {}

    def to_manifest(self) -> dict:
        return {"succeeded": self.succeeded, "failed": self.failed,
                "skipped": self.skipped, "seconds": self.seconds}


def run_fleet(subjects: Sequence[str], fn: Callable[[str], object],
              workers: int = 1, done_check: Optional[Callable[[str], bool]] = None,
              manifest_path: Optional[str] = None,
              verbose: bool = True) -> FleetResult:
    """Apply ``fn(subject)`` to every subject with failure isolation.

    done_check: idempotent-resume predicate (like the reference's
    seg-file existence check, ``deploy_network.py:62-67``).
    """
    result = FleetResult()

    def one(subject: str):
        t0 = time.time()
        try:
            # done_check is caller-supplied code reading subject outputs —
            # a corrupt file must fail THAT subject, not abort the fleet
            if done_check is not None and done_check(subject):
                return ("skipped", subject, None, 0.0)
            fn(subject)
            return ("ok", subject, None, time.time() - t0)
        except Exception:
            return ("failed", subject, traceback.format_exc(),
                    time.time() - t0)

    if workers <= 1:
        outcomes = [one(s) for s in subjects]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            outcomes = [f.result()
                        for f in as_completed(pool.submit(one, s)
                                              for s in subjects)]

    for status, subject, err, dt in outcomes:
        result.seconds[subject] = dt
        if status == "ok":
            result.succeeded.append(subject)
            if verbose:
                print(f"{subject}: ok ({dt:.2f}s)")
        elif status == "skipped":
            result.skipped.append(subject)
        else:
            result.failed[subject] = err
            if verbose:
                print(f"{subject}: FAILED\n{err}")

    if manifest_path:
        with open(manifest_path, "w") as f:
            json.dump(result.to_manifest(), f, indent=2)
    return result
