"""The reference's examples in the port, each run with ``python -m``:
``quickstart`` (every paper algorithm on the cost model, then a real
measurement on the card), ``tune_kernel`` (GA over add's geometry on the
card) and ``train_lm`` (a Mamba-2 LM under the fault-tolerant runner)."""
