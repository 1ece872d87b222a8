"""stream — the OINK surface of the standing-query engine
(``stream/engine.py``; the counterpart of
``gpu_mapreduce_tpu/oink/commands/stream.py``).

One subcommand per invocation; the stream's directory IS the handle —
every invocation re-opens it and resumes from the last committed
micro-batch (exactly-once, ft/ journal):

* ``stream open <dir> <source...> [parser=words] [reduce=count]
  [window=N]`` — create (or re-open) the query; the spec persists in
  ``<dir>/stream.json`` so later subcommands need only the directory.
* ``stream poll <dir>``     — drain everything pending NOW (forced
  cut: deterministic scripts don't wait on the time trigger).
* ``stream status <dir>``   — one status line + the JSON detail.
* ``stream snapshot <dir> [outfile]`` — the resident dataset's
  deterministic text snapshot (sorted ``key value`` lines), printed or
  written to ``outfile``.
* ``stream close <dir>``    — final drain (unterminated tail line
  included) + the terminal ``stream_close`` record.

The stream's datasets live on the script's device or mesh.
"""

from __future__ import annotations

import json
import os

from ...core.runtime import MRError
from ..command import Command, command

_SUBS = ("open", "poll", "status", "snapshot", "close")
_SPEC_KEYS = ("parser", "reduce", "window")


@command("stream")
class StreamCmd(Command):
    ninputs = 0
    noutputs = 0

    def params(self, args):
        if len(args) < 2 or args[0] not in _SUBS:
            raise MRError("Illegal stream command: stream "
                          "<open|poll|status|snapshot|close> <dir> ...")
        self.sub = args[0]
        self.dir = args[1]
        self.rest = list(args[2:])
        if self.sub == "open" and not any("=" not in a
                                          for a in self.rest):
            raise MRError("Illegal stream command: open needs at "
                          "least one source file/directory")
        if self.sub != "open" and self.sub != "snapshot" and self.rest:
            raise MRError(f"Illegal stream command: {self.sub} takes "
                          f"no extra arguments")
        if self.sub == "snapshot" and len(self.rest) > 1:
            raise MRError("Illegal stream command: snapshot takes at "
                          "most one output file")

    def _spec_path(self) -> str:
        return os.path.join(self.dir, "stream.json")

    def _load_spec(self) -> dict:
        try:
            with open(self._spec_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            raise MRError(f"no stream at {self.dir!r} (run "
                          f"'stream open' first)") from None

    def _open_engine(self, spec: dict):
        from ...stream import Stream
        return Stream(self.dir, spec["sources"],
                      parser=spec.get("parser", "words"),
                      reduce=spec.get("reduce", "count"),
                      window=int(spec.get("window") or 0),
                      device=self.obj.device, comm=self.obj.comm,
                      settings=self.obj.defaults)

    def run(self):
        if self.sub == "open":
            spec = {"parser": "words", "reduce": "count", "window": 0}
            sources = []
            for a in self.rest:
                key, _, val = a.partition("=")
                if val and key in _SPEC_KEYS:
                    spec[key] = int(val) if key == "window" else val
                else:
                    sources.append(os.path.abspath(a))
            spec["sources"] = sources
            s = self._open_engine(spec)     # validates parser/reduce
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._spec_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(spec, f)
            os.replace(tmp, self._spec_path())
            st = s.status()
            s.suspend()
            self.stream_status = st
            self.message(
                f"Stream: open {self.dir} ({spec['parser']}/"
                f"{spec['reduce']}, {len(sources)} sources"
                + (f", resumed at batch {st['batches']}"
                   if st["resumed"] else "") + ")")
            return
        spec = self._load_spec()
        s = self._open_engine(spec)
        if self.sub == "poll":
            rows = s.drain()
            st = s.status()
            s.suspend()
            self.stream_status = st
            self.message(f"Stream: {rows} rows in "
                         f"{st['batches']} batches total, "
                         f"{st['pending_bytes']} bytes pending")
        elif self.sub == "status":
            st = s.status()
            s.suspend()
            self.stream_status = st
            self.message(f"Stream: {st['state']}, "
                         f"{st['batches']} batches, {st['rows']} rows, "
                         f"lag {st['lag_s']:.3f}s")
            out = json.dumps(st, indent=2, sort_keys=True, default=str)
            if self.screen is None or self.screen is True:
                print(out)
            elif self.screen is not False:
                self.screen.write(out + "\n")
        elif self.sub == "snapshot":
            text = s.snapshot()
            st = s.status()
            s.suspend()
            self.stream_status = st
            if self.rest:
                tmp = self.rest[0] + ".tmp"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, self.rest[0])
                self.message(f"Stream: snapshot of "
                             f"{st['rows']} rows -> {self.rest[0]}")
            else:
                self.message(f"Stream: snapshot at batch "
                             f"{st['batches']}")
                if self.screen is None or self.screen is True:
                    print(text, end="")
                elif self.screen is not False:
                    self.screen.write(text)
        else:                               # close
            st = s.close(drain=True)
            self.stream_status = st
            self.message(f"Stream: closed after {st['batches']} "
                         f"batches, {st['rows']} rows")
        self.obj.cleanup()
