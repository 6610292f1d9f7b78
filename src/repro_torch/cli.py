"""``python -m repro_torch`` — the shell front door over the port's DSE stack.

Subcommands:

- ``run <spec.json>``: load a declarative ``Study`` spec, compile it
  through the batched engine, and write the versioned ``StudyResult``
  artifact (JSON). ``-`` reads the spec from stdin. ``--cache DIR``
  stores every evaluated sub-grid chunk content-addressed under DIR
  (spec-hash keyed; see ``core.cache``); ``--resume DIR`` re-runs the
  spec persisted inside an existing cache directory, loading finished
  chunks and computing only the missing ones — the recovery path for
  interrupted large-scale sweeps. ``--workers N`` farms a
  ``kind='search'`` study's generation blocks to N worker processes;
  ``--device`` overrides ``analysis.device`` (the torch backend's
  device, and where a ``calibrate`` study measures).
- ``example-spec <kind>``: print a small runnable template spec for any
  analysis kind (evaluate | schedule | pareto | advise | sweep |
  roofline | search | calibrate | serve); a template, like any spec
  that names no backend, runs at ``backend='torch'``, so
  ``python -m repro_torch example-spec KIND | python -m repro_torch run -``
  runs it on the card (``run - --device cpu`` on the CPU).
- ``report``: regenerate the paper's sections (``repro_torch.report``:
  dryrun, roofline, dse, network, search, calibrate, serve, thermal;
  ``--sections`` picks some) on ``--device`` (``cuda``, the default, or
  ``cpu``), written as ``<section>_section.md`` and ``summary.json``
  under ``--out-dir`` (default ``experiments/report_torch/``; the JAX
  package's ``experiments/*_section.md`` are never written).
  ``--cache [DIR]`` chunk-caches the live studies (default
  ``.repro_torch_cache/`` at the repo root).
- ``bench`` raises ``NotImplementedError``: the JAX package's runs
  ``benchmarks/*_bench.py``, which import that package; the port's own
  benchmark is not written yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from .core.cache import DEFAULT_CACHE_DIR, ResultCache
from .core.study import ANALYSIS_KINDS, Study
from .report import SECTIONS

def _find_resume_spec(resume: pathlib.Path) -> pathlib.Path:
    """Locate spec.json inside a cache directory (study dir or root)."""
    if (resume / "spec.json").is_file():
        return resume / "spec.json"
    specs = sorted(resume.glob("*/spec.json"))
    if len(specs) == 1:
        return specs[0]
    if not specs:
        raise SystemExit(
            f"error: no spec.json under {resume} — point --resume at a cache "
            "directory written by `repro_torch run --cache`"
        )
    raise SystemExit(
        f"error: {resume} holds {len(specs)} cached studies; point --resume "
        "at one study directory: " + ", ".join(str(s.parent) for s in specs)
    )


def _cmd_run(args) -> int:
    cache = None
    if args.resume:
        if args.spec:
            raise SystemExit("error: give either a spec file or --resume, not both")
        if args.cache is not None:
            raise SystemExit(
                "error: --resume already names the cache directory; drop --cache"
            )
        spec_path = _find_resume_spec(pathlib.Path(args.resume))
        text = spec_path.read_text()
        src = str(spec_path)
        cache = ResultCache(spec_path.parent.parent)
    elif args.spec == "-":
        text = sys.stdin.read()
        src = "<stdin>"
    elif args.spec:
        path = pathlib.Path(args.spec)
        if not path.exists():
            raise SystemExit(f"error: spec file {path} does not exist")
        text = path.read_text()
        src = str(path)
    else:
        raise SystemExit("error: need a spec file ('-' for stdin) or --resume DIR")
    try:
        study = Study.from_json(text)
    except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
        # TypeError covers misspelled spec fields (unexpected kwargs)
        raise SystemExit(f"error: invalid study spec {src}: {e}") from None
    # workers and device are execution knobs (never part of the cache
    # key): override in place so --resume composes across them
    knobs = {k: v for k, v in (("workers", args.workers), ("device", args.device))
             if v is not None}
    if knobs:
        try:
            study = dataclasses.replace(
                study, analysis=dataclasses.replace(study.analysis, **knobs)
            )
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
    if cache is None and args.cache is not None:
        cache = ResultCache(args.cache or DEFAULT_CACHE_DIR)
    result = study.run(cache=cache)
    if args.out:
        out = result.save(args.out)
        print(f"wrote {out}")
    else:
        print(result.to_json())
    print(result.describe(), file=sys.stderr)
    if cache is not None:
        st = result.cache
        print(
            f"cache {cache.study_dir(study)}: {st['hits']} chunk(s) reused, "
            f"{st['misses']} computed",
            file=sys.stderr,
        )
    return 0


def _cmd_example_spec(args) -> int:
    study = Study.example(args.kind)
    if args.transient:
        try:
            study = dataclasses.replace(
                study,
                name=study.name + "-transient",
                analysis=dataclasses.replace(
                    study.analysis, thermal="transient"
                ),
            )
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
    print(study.to_json())
    return 0


def _cmd_report(args) -> int:
    from . import report

    cache = None
    if args.cache is not None:
        cache = args.cache or str(report.ROOT / DEFAULT_CACHE_DIR)
    for path in report.main(sections=args.sections, cache=cache, device=args.device,
                            out_dir=args.out_dir):
        print(f"wrote {path}", file=sys.stderr)
    return 0


def _cmd_not_ported(args) -> int:
    raise NotImplementedError(
        f"`repro_torch {args.command}` is not ported: the JAX package's runs "
        "benchmarks/*_bench.py, which import that package; the port's own "
        "benchmark is the work of a benchmark PR of its own"
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Declarative Study front door over the 3D-IC DSE stack "
                    "(PyTorch port).",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run a Study spec, write the artifact")
    run.add_argument("spec", nargs="?", default=None,
                     help="path to a Study spec JSON ('-' for stdin)")
    run.add_argument("--out", "-o", default=None,
                     help="artifact path (default: print JSON to stdout)")
    run.add_argument("--cache", nargs="?", const="", default=None, metavar="DIR",
                     help="content-addressed chunk cache directory "
                          f"(default when flag given: {DEFAULT_CACHE_DIR})")
    run.add_argument("--resume", default=None, metavar="DIR",
                     help="continue an interrupted cached run: DIR is the "
                          "cache root (single study) or one <spec-hash> "
                          "study directory; only missing chunks are computed")
    run.add_argument("--workers", type=int, default=None, metavar="N",
                     help="farm kind='search' generation blocks to N worker "
                          "processes (overrides the spec's analysis.workers; "
                          "results are bit-identical at any count)")
    run.add_argument("--device", default=None, metavar="DEV",
                     help="the torch backend's device, and where a calibrate "
                          "study measures: cuda (the default), cuda:N or cpu "
                          "(overrides the spec's analysis.device)")
    run.set_defaults(fn=_cmd_run)

    ex = sub.add_parser("example-spec",
                        help="print a runnable template spec (backend='torch')")
    ex.add_argument("kind", nargs="?", default="evaluate",
                    choices=list(ANALYSIS_KINDS))
    ex.add_argument("--transient", action="store_true",
                    help="switch the template to the transient thermal/DVFS "
                         "model (thermal='transient' + a default DvfsSpec; "
                         "evaluate/pareto/roofline/schedule/serve kinds)")
    ex.set_defaults(fn=_cmd_example_spec)

    rep = sub.add_parser("report", help="regenerate the paper's report sections "
                                        "(default: under experiments/report_torch/)")
    rep.add_argument("--sections", nargs="*", default=None, choices=list(SECTIONS),
                     help="the sections to write (default: all)")
    rep.add_argument("--cache", nargs="?", const="", default=None, metavar="DIR",
                     help="content-addressed chunk cache directory "
                          f"(default when flag given: {DEFAULT_CACHE_DIR} at the repo root)")
    rep.add_argument("--device", default="cuda", metavar="DEV",
                     help="where the studies run and calibrate measures: cuda (the "
                          "default), cuda:N or cpu")
    rep.add_argument("--out-dir", default=None, metavar="DIR",
                     help="where the sections and summary.json go (default: "
                          "experiments/report_torch/)")
    rep.set_defaults(fn=_cmd_report)
    sub.add_parser("bench", help="run the repo benchmarks (not ported: the port's own "
                                 "benchmark is not written yet)"
                   ).set_defaults(fn=_cmd_not_ported)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
