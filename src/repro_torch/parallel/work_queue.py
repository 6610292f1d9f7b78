"""Multi-process work queue over the chunk-cache protocol.

The guided search (``core.search``) decomposes every generation into
content-addressed cache blocks. This module farms the *missing* blocks
of a generation to N worker processes: each worker rebuilds the Study
from its JSON spec, prices its candidate block through the same
``search.evaluate_candidates`` path as the in-process runner, and
atomically stores the chunk file. The parent collects the chunks — the
cache IS the transport, so there is no result pickling, a killed worker
leaves no partial state (atomic writes), and a crashed run resumes
exactly like a single-process one.

Chunk payloads are bit-identical across worker counts (the evaluation
is deterministic and JSON float64 round-trips are exact), which is why
``AnalysisSpec.workers`` is an execution knob excluded from the spec
hash — a sweep started with one worker resumes with eight. The spec's
``backend`` and ``device`` travel in its JSON, so a worker searches on
the device the parent was asked for.

Start method: ``spawn``, for both backends. A forked child cannot use
CUDA once the parent has initialised it, and the parent imports torch
(whose thread pools are not fork-safe) even for ``backend='numpy'``.
Spawned children re-import the package by name, so its ``src`` goes on
``PYTHONPATH`` first.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import pathlib

__all__ = ["WorkerPool"]


def _eval_store(study_json: str, cache_root: str, block_cells: int, key: str,
                cands) -> str:
    """Worker body: price one candidate block, store its chunk, return key."""
    import numpy as np

    from ..core.cache import ResultCache
    from ..core.search import chunk_payload, evaluate_candidates
    from ..core.study import Study

    study = Study.from_json(study_json)
    cache = ResultCache(cache_root, block_cells=block_cells)
    c = np.asarray(cands, dtype=np.int64)
    objs, feas = evaluate_candidates(study, c)
    cache.store_chunk(study, key, chunk_payload(c, objs, feas))
    return key


def _ensure_importable() -> None:
    """Make sure spawn children can ``import repro_torch`` (they re-import
    this module by qualified name; sys.path does not inherit, PYTHONPATH
    does)."""
    root = str(pathlib.Path(__file__).resolve().parents[2])
    pp = os.environ.get("PYTHONPATH", "")
    if root not in pp.split(os.pathsep):
        os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (root, pp) if p)


class WorkerPool:
    """Up to ``workers`` spawned processes, started at the first ``run``
    and kept until ``close``: a search pays the start-up (the torch
    import, and a CUDA context on the card) once, not once per
    generation."""

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self._ex = None

    def run(self, study_json: str, cache_root: str, block_cells: int, jobs) -> list[str]:
        """Farm ``jobs`` = [(chunk_key, candidate_rows), ...] to the
        workers. Blocks until every chunk is stored (or re-raises the
        first worker failure). Returns the completed keys in submission
        order."""
        jobs = list(jobs)
        if not jobs:
            return []
        if self._ex is None:
            _ensure_importable()
            self._ex = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.workers, mp_context=multiprocessing.get_context("spawn")
            )
        futs = [
            self._ex.submit(_eval_store, study_json, cache_root, block_cells, key, cands)
            for key, cands in jobs
        ]
        return [f.result() for f in futs]

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._ex = None

