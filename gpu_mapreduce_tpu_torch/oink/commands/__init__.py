"""Command plugin modules: importing one registers its commands in the
COMMANDS registry (the reference's generated style_command.h).  Ported:
rmat, rmat2, degree, degree_stats, degree_weight, edge_upper,
vertex_extract, neighbor, pagerank, cc_find, cc_stats, histo, luby_find,
tri_find, neigh_tri, sssp, wordfreq and invertedindex, each on one
device or a mesh; stream and the dump_* commands are not ported yet."""

from . import (cc, degree, edges, histo, invertedindex,  # noqa: F401
               luby, pagerank, rmat, sssp, tri, wordfreq)
