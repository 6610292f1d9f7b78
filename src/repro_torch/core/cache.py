"""Content-addressed result cache: resumable large-scale Study runs.

A ``Study`` spec is canonically hashable (sorted-key strict JSON of
everything except the cosmetic ``name``), and the engine's evaluation
is exactly decomposable into independent sub-grid chunks (the (R, C)
search is rowwise independent — see ``DesignGrid.subset``). Together
those give bit-for-bit resumability: ``Study.run(cache=...)`` stores
each evaluated chunk under

    <root>/<spec-hash>/spec.json            the spec (for --resume)
    <root>/<spec-hash>/chunks/<key>.json    one evaluated sub-grid
    <root>/<spec-hash>/result.json          the finished artifact

and a re-run (or ``python -m repro_torch run --resume <dir>``) loads every
chunk that already exists and computes only the missing ones.
**Invalidation rule**: the directory name IS the spec hash — any change
to the workload/space/constraints/analysis content lands in a fresh
directory; nothing is ever reused across differing specs. Fields that
provably cannot change a result bit (``name``, and the
backend/device/chunk/shard/workers execution knobs) are excluded, so an
interrupted sweep resumes across executor settings, and a spec hashes
to the same directory name as in the JAX package. The one kind whose
result depends on where it ran, ``calibrate``, keys its chunks on the
device it measured on instead (``Study._run_calibrate``). Chunk files
are written atomically (tmp + rename), so a killed run never leaves a
truncated chunk behind.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

__all__ = ["DEFAULT_CACHE_DIR", "ResultCache", "study_hash"]

#: conventional cache root (what the CLI uses when none is given). Not the
#: JAX package's ``.repro_cache``: a shared root would replay one
#: package's chunks in the other.
DEFAULT_CACHE_DIR = ".repro_torch_cache"

#: target result cells (workloads x points) per cached chunk — small
#: enough that an interrupted million-point sweep resumes at fine
#: granularity, large enough to amortize the engine's per-call setup.
DEFAULT_BLOCK_CELLS = 1 << 16


#: spec fields that cannot change a result bit and therefore do not key
#: the cache: ``name`` is cosmetic; backend ("identical integers"),
#: device (where the torch backend searches: the same integers),
#: chunk ("results are independent of it"), shard (rowwise-
#: independent search) and workers (the work queue's chunk payloads
#: are bit-identical across process counts) are execution knobs — an
#: interrupted unsharded single-process sweep can resume sharded with
#: eight workers without recomputing anything.
_NON_CONTENT_TOP = ("name",)
_NON_CONTENT_ANALYSIS = ("backend", "device", "chunk", "shard", "workers")


def study_hash(study) -> str:
    """Canonical content hash of a Study spec (16 hex chars).

    Hashes the sorted-key strict-JSON spec dict minus the
    result-invariant fields above; ``version`` bumps invalidate
    implicitly because the version is part of the dict.
    """
    d = dict(study.to_dict())
    for k in _NON_CONTENT_TOP:
        d.pop(k, None)
    if isinstance(d.get("analysis"), dict):
        d["analysis"] = {
            k: v for k, v in d["analysis"].items() if k not in _NON_CONTENT_ANALYSIS
        }
    canon = json.dumps(d, sort_keys=True, separators=(",", ":"), allow_nan=False)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


class ResultCache:
    """Spec-hash-keyed chunk store with hit/miss accounting.

    ``block_cells`` sets the chunking granularity Study uses when
    splitting a grid (the chunk *key* embeds the exact index range, so
    differently-sized chunks never alias — they just miss).
    """

    def __init__(self, root, block_cells: int = DEFAULT_BLOCK_CELLS):
        self.root = pathlib.Path(root)
        self.block_cells = int(block_cells)
        self.hits = 0
        self.misses = 0

    # -- layout -------------------------------------------------------------

    def study_dir(self, study) -> pathlib.Path:
        return self.root / study_hash(study)

    def prepare(self, study) -> pathlib.Path:
        """Create the study directory and persist the spec for --resume."""
        d = self.study_dir(study)
        (d / "chunks").mkdir(parents=True, exist_ok=True)
        spec = d / "spec.json"
        if not spec.exists():
            _atomic_write(spec, study.to_json() + "\n")
        return d

    # -- chunks -------------------------------------------------------------

    def load_chunk(self, study, key: str) -> dict | None:
        """The chunk's JSON payload, or None (counted as hit / miss)."""
        path = self.study_dir(study) / "chunks" / f"{key}.json"
        if path.exists():
            try:
                d = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                d = None  # unreadable -> recompute (atomic writes make this rare)
            if d is not None:
                self.hits += 1
                return d
        self.misses += 1
        return None

    def peek_chunk(self, study, key: str) -> dict | None:
        """``load_chunk`` without touching the hit/miss counters — how
        the work-queue parent collects chunks its workers just wrote
        (counting those as hits would mask real resume accounting)."""
        path = self.study_dir(study) / "chunks" / f"{key}.json"
        try:
            return json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def store_chunk(self, study, key: str, payload: dict) -> pathlib.Path:
        path = self.study_dir(study) / "chunks" / f"{key}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write(path, json.dumps(payload, allow_nan=False))
        return path

    def chunk_keys(self, study) -> list[str]:
        d = self.study_dir(study) / "chunks"
        return sorted(p.stem for p in d.glob("*.json")) if d.is_dir() else []

    # -- results ------------------------------------------------------------

    def store_result(self, study, result) -> pathlib.Path:
        path = self.study_dir(study) / "result.json"
        _atomic_write(path, result.to_json() + "\n")
        return path

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "chunks": self.hits + self.misses,
            "root": str(self.root),
        }


def _atomic_write(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)
