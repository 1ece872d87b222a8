"""Command plugin modules: importing one registers its commands in the
COMMANDS registry (the reference's generated style_command.h).  Only the
ported commands are here; sssp, luby, tri, histo, wordfreq,
invertedindex, stream and the dump_* commands are not ported yet."""

from . import cc, degree, edges, pagerank, rmat  # noqa: F401
