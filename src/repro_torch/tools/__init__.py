"""Command-line tools of the port, each run with ``python -m``:
``repro_torch.tools.compare_stores`` byte-compares two stores' values."""
