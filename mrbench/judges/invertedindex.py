"""Judge of the InvertedIndex job: each URL's reference count and file
set in the sampled jobs' outputs against the plain reference's parse of
the same files, and every job's totals.

Checks (exact, limit 0):

* ``wrong_urls`` — URL ids whose count or file set differ from the
  reference's, or that one side lacks;
* ``total_gap`` — the largest |references - R| + |URLs - U| over the
  jobs, R and U the reference's totals.

The system states no precision; the control breaks the guarantee that
every URL up to 255 bytes is indexed whole: the reference with the
64-byte first window only, the step a shortcut past the long-URL
regather would take.
"""

from __future__ import annotations

from ..ref import invindex


def reference(inputs, cfg, wl, device) -> dict:
    idx = invindex.index(inputs["paths"], wl["max_url"])
    return {"index": idx, "totals": invindex.totals(idx)}


def control(inputs, cfg, wl, device, ref) -> dict:
    idx = invindex.index(inputs["paths"], wl["control_window"])
    refs, urls = invindex.totals(idx)
    return {"outputs": {0: idx}, "jobs": [{"refs": refs, "urls": urls}]}


def compare(got, ref, wl):
    lim = wl["limits"]
    bad = {i: invindex.mismatches(idx, ref["index"])
           for i, idx in got["outputs"].items()}
    wrong = {i for i, b in bad.items() if b > lim["wrong_urls"]}
    R, U = ref["totals"]
    gap = 0
    for i, c in enumerate(got["jobs"]):
        if c is None:
            continue
        g = abs(c.get("refs", -1) - R) + abs(c.get("urls", -1) - U)
        if g > lim["total_gap"]:
            wrong.add(i)
        gap = max(gap, g)
    return {"wrong_urls": (max(bad.values(), default=len(ref["index"])),
                           lim["wrong_urls"]),
            "total_gap": (gap, lim["total_gap"])}, wrong
