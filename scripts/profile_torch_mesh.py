#!/usr/bin/env python3
"""The mesh data plane with one shard a card, beside four shards on one.

    python3 scripts/profile_torch_mesh.py [--mb 256] [--rounds 2]

Runs chip_smoke's mesh pieces — InvertedIndex on the main cell's corpus
(``--mb`` MB, one file a shard), IntCount on the uniform and zipf keys
(2^25 u32 each, four files) and the card-vs-CPU check — on two meshes of
four shards: ``make_mesh(min(4, cards))`` (one shard a card, the
exchange's copies between cards) and four shards on cuda:0, alternating
which goes first, ``--rounds`` times.  Each run carries the same gates
as the smoke (the generator's pairs, numpy's counts, mark_words once a
shard a pass, seg_table never, card ≡ CPU).  Prints one JSON line per
run (end-to-end seconds, stages, the exchange's seconds, count matrix
and bytes, peak bytes per card), then the card's name and power limit.
Exits nonzero without a card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_mesh: no CUDA device is available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import chip_smoke as cs
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    kernels = [match.mark_words, group.segment_table, match.mark]
    smi = cs.nvidia_smi()
    count = torch.cuda.device_count()
    meshes = {"cards": [torch.device("cuda", i)
                        for i in range(min(4, count))],
              "one_card": cs.mesh_devices()}
    tmp = tempfile.mkdtemp(prefix="profile_mesh_")
    try:
        d = os.path.join(tmp, "main")
        os.makedirs(d)
        paths, nref, nuniq = make_corpus(d, args.mb)
        int_keys = cs.intcount_files(tmp)[1]
        one = {"stages_s": {}, "end_to_end_s": None}
        for r in range(args.rounds):
            order = list(meshes) if r % 2 == 0 else list(meshes)[::-1]
            for name in order:
                devs = meshes[name]
                if len(devs) < cs.MESH_P and name == "cards":
                    continue          # fewer than four cards: one a card
                t0 = time.perf_counter()
                rec = {"round": r, "mesh": name,
                       "devices": [str(x) for x in devs],
                       "main": cs.run_mesh_main(paths, nref, nuniq, one,
                                                kernels, smi, devs),
                       "intcount": {cell: cs.run_mesh_intcount(
                           cell, keys, tmp, kernels, smi, devs)
                           for cell, keys in int_keys.items()},
                       "check": cs.run_mesh_check(tmp, smi, devs)}
                rec["seconds"] = time.perf_counter() - t0
                cs.emit({"mesh": name, "round": r, "card": smi,
                         "cards": len(set(devs)),
                         "main": {k: rec["main"][k] for k in (
                             "end_to_end_s", "stages_s", "exchange",
                             "launches", "max_memory_allocated")},
                         "intcount": {c: {k: v[k] for k in (
                             "end_to_end_s", "stages_s", "exchange_s",
                             "exchange_bound_ms", "count_matrix",
                             "cssize", "max_memory_allocated")}
                             for c, v in rec["intcount"].items()},
                         "check": rec["check"]["seconds"],
                         "seconds": rec["seconds"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
