"""``python -m repro_torch`` entry point (see ``repro_torch.cli``)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
