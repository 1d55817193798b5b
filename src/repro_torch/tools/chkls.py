"""``python -m repro_torch.tools.chkls <file.chk5 | objstore-root>`` — inspect
CHK5 containers and object-store checkpoint catalogs.

The paper's HDF5 argument: checkpoints double as analyzable datasets, with
standard tools. This is that tool for CHK5.  Clause-carrying stores
(core/protect.Protect) record their clauses as dataset attributes — the
listing shows the interesting ones (codec, kind, precision, fallbacks) and
``--json`` emits the full machine-readable inventory so CI can assert on
container contents.

Pointed at a *directory* (an object-store root — the ``file:`` bucket of
repro_torch.objstore, e.g. ``<ckpt-dir>/objstore``), it lists the checkpoint
catalog instead: every published entry (id, kind/level from the recorded
manifest, file set with chunk counts, pin state) plus the store-wide
chunk inventory — ``--json`` again machine-readable for CI.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.core.formats import CHK5Reader

#: clause/codec attrs worth a column in the human listing
_CLAUSE_ATTRS = ("codec", "kind", "precision", "codec_fallback",
                 "precision_fallback")


def _clause_str(name: str, attrs: dict) -> str:
    parts = []
    if name.startswith("shardidx/"):
        # the shard index of a sharded leaf: summarize the chunk set so the
        # listing shows where the payload actually lives
        parts.append(f"sharded n_chunks={attrs.get('n_chunks')} "
                     f"global={tuple(attrs.get('global_shape', ()))} "
                     f"over {len(set(attrs.get('files', [])))} file(s)")
    for k in _CLAUSE_ATTRS:
        if k in attrs:
            parts.append(f"{k}={attrs[k]}")
    return " ".join(parts)


def catalog_inventory(root: str) -> dict:
    """Deprecated shim: the machine-readable catalog listing for an
    object-store root.  The typed surface is
    ``repro_torch.objstore.inspect.CatalogView`` — this keeps the historical
    dict shape for callers that still want plain JSON."""
    from repro_torch.objstore.inspect import CatalogView
    return CatalogView.from_root(root, count_chunks=True).to_inventory(root)


def list_catalog(root: str, as_json: bool) -> int:
    from repro_torch.objstore.catalog import CATALOG_KEY
    from repro_torch.objstore.client import make_object_store
    store = make_object_store(f"file:{root}")
    # refuse to call an arbitrary directory an "empty catalog" — a wrong
    # path (the ckpt root instead of <root>/objstore) must fail loudly,
    # not read as a store that exists and holds nothing
    if not store.exists(CATALOG_KEY) and not store.list("chunks/"):
        print(f"{root}: not an object-store root (no {CATALOG_KEY}, no "
              f"chunks/) — point chkls at the bucket, e.g. "
              f"<ckpt-dir>/objstore", file=sys.stderr)
        return 2
    inv = catalog_inventory(root)
    if as_json:
        print(json.dumps({"catalog": inv}, indent=1, sort_keys=True))
        return 0
    if not inv["entries"]:
        print(f"{root}: empty catalog (epoch {inv['epoch']})")
        return 0
    print(f"catalog at {root}: epoch {inv['epoch']}, "
          f"{inv['stored_chunks']} stored chunks")
    for e in inv["entries"]:
        pin = " pinned" if e["pinned"] else ""
        hist = " ".join(f"{k}:{v}" for k, v in e["chunk_hist"].items())
        print(f"  ckpt {e['id']:<6d} kind={e['kind']} level={e['level']}"
              f" files={len(e['files'])} chunks={e['n_chunks']}"
              f" {e['total_bytes']:,d} B{pin}")
        if hist:
            print(f"    chunk sizes [{e['chunk_bytes_min']:,d}"
                  f"..{e['chunk_bytes_max']:,d}] B  hist {hist}")
        for name, f in e["files"].items():
            print(f"    {name:40s} {f['size']:>12,d} B"
                  f"  ({f['n_chunks']} {f['mode']} chunks)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="list CHK5 checkpoint contents (or, for a directory, "
                    "an object-store checkpoint catalog)")
    ap.add_argument("file")
    ap.add_argument("--verify", action="store_true", help="check all crc32s")
    ap.add_argument("--stats", action="store_true",
                    help="per-dataset min/max/mean for float data")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable inventory (attrs included)")
    args = ap.parse_args(argv)

    if os.path.isdir(args.file):
        return list_catalog(args.file, args.as_json)

    rd = CHK5Reader(args.file, verify=args.verify)

    if args.as_json:
        datasets = []
        for name in rd.datasets():
            m = rd.info(name)
            datasets.append({"name": name, "dtype": m["dtype"],
                             "shape": list(m["shape"]),
                             "nbytes": m["nbytes"],
                             "attrs": m.get("attrs", {})})
        inv = {
            "file": args.file,
            "attrs": rd.attrs(""),
            "datasets": datasets,
            "total_bytes": sum(d["nbytes"] for d in datasets),
            "verified": bool(args.verify),
        }
        print(json.dumps(inv, indent=1, sort_keys=True))
        rd.close()
        return 0

    root_attrs = rd.attrs("")
    if root_attrs:
        print(f"attrs: {root_attrs}")
    total = 0
    for name in rd.datasets():
        m = rd.info(name)
        total += m["nbytes"]
        line = (f"  {name:60s} {m['dtype']:>10s} "
                f"{str(tuple(m['shape'])):>20s} {m['nbytes']:>12,d} B")
        clauses = _clause_str(name, m.get("attrs", {}))
        if clauses:
            line += f"  [{clauses}]"
        if args.stats and m["dtype"] != "bytes":
            try:
                a = rd.read_dataset(name).astype(np.float32)
                if a.size:
                    line += (f"  [{a.min():+.3e}, {a.max():+.3e}]"
                             f" μ={a.mean():+.3e}")
            except (TypeError, ValueError):
                pass
        print(line)
    print(f"{len(rd.datasets())} datasets, {total:,} bytes"
          + ("  (crc OK)" if args.verify else ""))
    rd.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
