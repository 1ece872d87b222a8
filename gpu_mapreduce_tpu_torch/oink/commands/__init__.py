"""Command plugin modules: importing one registers its commands in the
COMMANDS registry (the reference's generated style_command.h).  Ported:
rmat, rmat2, degree, degree_stats, degree_weight, edge_upper,
vertex_extract, neighbor, pagerank, cc_find, cc_stats, histo, luby_find,
tri_find, neigh_tri, sssp, wordfreq and invertedindex, each on one
device or a mesh, the observability exits dump_trace, dump_metrics and
dump_plan, and the standing-query family stream (open, poll, status,
snapshot, close)."""

from . import (cc, degree, dump_metrics, dump_plan,  # noqa: F401
               dump_trace, edges, histo, invertedindex, luby, pagerank,
               rmat, sssp, stream, tri, wordfreq)
