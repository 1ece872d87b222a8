"""Command plugin modules: importing one registers its commands in the
COMMANDS registry (the reference's generated style_command.h).  Only the
ported commands are here (rmat, rmat2, degree, degree_stats,
degree_weight, edge_upper, vertex_extract, neighbor, pagerank, cc_find,
cc_stats, histo, luby_find, tri_find, neigh_tri, sssp and wordfreq);
invertedindex, stream and the dump_* commands are not ported yet."""

from . import (cc, degree, edges, histo, luby, pagerank,  # noqa: F401
               rmat, sssp, tri, wordfreq)
