"""Byte-compare the measurement VALUES of two stores.

The executor layer's contract is that every executor — serial, process,
futures, device — produces the same measured values, down to the byte, in
the merged store.  This tool checks exactly that: it loads two stores
(``.json`` or ``.sqlite``, inferred from the extension), serializes their
``(key, value)`` payloads canonically (sorted keys, full float repr via
``json``), and exits 0 iff the payloads are identical.

Metadata is deliberately excluded: the meta side-channel carries unit
journals and provenance whose wall-clocks legitimately differ between runs.
``--meta`` adds a *key-set* comparison of the metadata (still ignoring the
values, which embed timings).

Usage:
    python -m repro_torch.tools.compare_stores results/a_cache.json results/b_cache.json
"""

from __future__ import annotations

import argparse
import json
import os

from ..core import MeasurementStore, SqliteMeasurementStore


def load(path: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".sqlite") or path.endswith(".db"):
        return SqliteMeasurementStore(path)
    return MeasurementStore(path)


def values_bytes(store) -> bytes:
    return json.dumps(
        sorted((str(k), float(v)) for k, v in store.items()), sort_keys=True
    ).encode()


def meta_keys(store) -> set:
    if not hasattr(store, "meta_items"):
        return set()
    return {k for k, _ in store.meta_items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.compare_stores",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("store_a")
    ap.add_argument("store_b")
    ap.add_argument("--meta", action="store_true",
                    help="also compare metadata key sets")
    args = ap.parse_args(argv)

    a, b = load(args.store_a), load(args.store_b)
    pa, pb = values_bytes(a), values_bytes(b)
    items_a, items_b = dict(a.items()), dict(b.items())
    n_a, n_b = len(items_a), len(items_b)
    if pa != pb:
        only_a, only_b = items_a.keys() - items_b.keys(), items_b.keys() - items_a.keys()
        diff = sorted(
            k for k in items_a.keys() & items_b.keys()
            if float(items_a[k]) != float(items_b[k])
        )
        print(f"DIFFER: {args.store_a} ({n_a} entries) vs "
              f"{args.store_b} ({n_b} entries)")
        for label, keys in (("only in A", only_a), ("only in B", only_b),
                            ("value mismatch", diff)):
            for k in sorted(keys)[:5]:
                print(f"  {label}: {k}")
            if len(keys) > 5:
                print(f"  {label}: ... {len(keys) - 5} more")
        return 1
    print(f"IDENTICAL: {n_a} measurement entries, {len(pa)} payload bytes")
    if args.meta:
        ma, mb = meta_keys(a), meta_keys(b)
        if ma != mb:
            print(f"META KEYS DIFFER: {len(ma - mb)} only in A, "
                  f"{len(mb - ma)} only in B")
            return 1
        print(f"meta key sets identical ({len(ma)} keys)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
