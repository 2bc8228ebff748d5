"""The paper's drivers, run with ``python -m``: ``paper_matrix`` runs the
experiment matrix combo by combo, ``run`` prints the paper's tables and the
card's kernel timings as ``name,us_per_call,derived`` CSV rows."""
