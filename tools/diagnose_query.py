"""Diagnose why a workload query returns zero rows on the synthetic IMDB.

Computes, per query entity, the filtered row count and the surviving
movie-id / person-id sets after semi-joining through dimension filters
(keyword, comp_cast_type, char_name, info_type, ...), then prints the
cumulative intersection — the first step that hits zero is the starved
link. Host-side numpy only; no engine involved.

Run: python tools/diagnose_query.py s29 [--scale 0.1]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

from radixjoin.harness import datagen
from radixjoin.harness.run import load_workload
from radixjoin.sql import catalog
from radixjoin.sql.frontend import ParsedSQL


def col(table, name):
    for i, (c, _dt) in enumerate(catalog.ATTRIBUTES[table]):
        if c == name:
            return i
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("query")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    names, _, queries = load_workload()
    tabs = datagen.generate_cached(
        args.scale, args.seed, queries,
        cache_dir=os.path.join(REPO, ".bench_cache"),
    )
    sql = queries[names.index(args.query)]
    p = ParsedSQL(sql)

    # pass 1: filter masks + per-entity id sets
    masks, ids = {}, {}
    for ent in p.alias_map.values():
        t = tabs[ent.table]
        stmt = p.filters.get(ent)
        bm = (np.asarray(stmt.eval_table(t), bool)
              if stmt is not None else np.ones(t.num_rows, bool))
        masks[ent] = bm
        ids[ent] = set(
            (t.columns[0].values[bm]).tolist()
        )  # own id column survivors
        print(f"{str(ent):22} filtered {int(bm.sum()):>10}/{t.num_rows}")

    # pass 2: iterate semi-joins over the join graph until fixpoint
    import itertools

    def column_values(ent, cname, mask):
        t = tabs[ent.table]
        ci = col(ent.table, cname)
        c = t.columns[ci]
        vals = c.values[mask & c.valid] if c.values is not None else None
        return vals

    changed = True
    rounds = 0
    while changed and rounds < 8:
        changed = False
        rounds += 1
        for a, nbrs in p.join_graph.items():
            for b, (ca, cb) in nbrs.items():
                va = column_values(a, ca, masks[a])
                vb = column_values(b, cb, masks[b])
                sa, sb = set(va.tolist()), set(vb.tolist())
                inter = sa & sb
                for ent, cname, s in ((a, ca, sa), (b, cb, sb)):
                    if len(inter) < len(s):
                        t = tabs[ent.table]
                        c = t.columns[col(ent.table, cname)]
                        keep = np.isin(
                            c.values, np.fromiter(
                                inter, dtype=c.values.dtype,
                                count=len(inter),
                            )
                        ) & c.valid
                        new = masks[ent] & keep
                        if new.sum() < masks[ent].sum():
                            masks[ent] = new
                            changed = True
        line = ", ".join(
            f"{str(e)}={int(m.sum())}" for e, m in masks.items()
        )
        print(f"round {rounds}: {line}")
        if any(m.sum() == 0 for m in masks.values()):
            dead = [str(e) for e, m in masks.items() if m.sum() == 0]
            print(f"STARVED at: {dead}")
            break


if __name__ == "__main__":
    main()
