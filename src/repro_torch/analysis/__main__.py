"""``python -m repro_torch.analysis <results_dir>`` — alias for the report CLI."""

from .report import main

if __name__ == "__main__":
    raise SystemExit(main())
