"""The OINK input-script interpreter.

The counterpart of ``gpu_mapreduce_tpu/oink/script.py`` (reference
``oink/input.{h,cpp}``): a line reader with ``&`` continuation,
quote-aware ``#`` comments and ``$x``/``${x}`` substitution; the builtins
clear, echo, if, include, jump, label, log, next, print, shell and
variable; the OINK commands input, output, set and ``mr``; named-MR
method lines (``mrscript.py``); registered commands with ``-i``/``-o``
switches; the ft journal's hooks and its ``resume`` builtin; and the
``oink.cpp`` command line (``-in``, ``-log``, ``-screen``, ``-echo``,
``-var``, ``-partition``).

Every MR a script makes lives on its ``ObjectManager``'s device: the card
unless the caller passes ``device="cpu"``.  ``-partition`` runs one
interpreter a world, each over its sub-mesh, in threads
(``universe.py``).  With ``MRTPU_JOURNAL`` set, every completed command
is journaled and the named MRs checkpoint every ``MRTPU_CKPT_EVERY``
commands (``ft/journal.py``); ``resume <dir>`` replays a killed script
from its last checkpoint.  A top-level script is one request of
``obs/context.py`` (one trace id), every command and named-MR line is an
``oink.<command>`` span, and each command round is a cancellation
barrier.  Every named-MR method of the JAX ``mrscript.py`` and every
``set`` setting (the 15 fields of ``core/runtime.Settings``) is ported.
"""

from __future__ import annotations

import os
import shutil
import sys
import time as _time
from typing import List, Optional, TextIO

from ..core.runtime import MRError
from . import commands  # noqa: F401  (registers the ported commands)
from .command import COMMANDS
from .mrscript import MRScriptDispatch, expand_path_variable
from .objects import ObjectManager
from .variables import Variables

class OinkScript:
    """One interpreter: variable table + object manager + log.

    ``device``: where every MR of the script lives (None → the card);
    ``comm``: a mesh instead, whose width the ``nprocs`` variable reads.
    ``screen``: None → stdout, False → silent, or a file-like.
    ``world``: this interpreter's ``WorldContext`` in a ``-partition``
    universe (None: one world)."""

    def __init__(self, device=None, screen=None,
                 logfile: Optional[str] = None, comm=None, world=None,
                 obj: Optional[ObjectManager] = None):
        # obj: a caller-owned namespace (a serve/ session's, with its
        # pinned budget settings)
        self.obj = obj if obj is not None \
            else ObjectManager(device, comm=comm)
        self.variables = Variables(world=world)
        self.screen: Optional[TextIO]
        if screen is None:
            self.screen = sys.stdout
        elif screen is False:
            self.screen = None
        else:
            self.screen = screen
        self.logfile: Optional[TextIO] = open(logfile, "w") if logfile \
            else None
        self.echo_screen = False       # reference default: echo log only
        self.echo_log = True
        self.deltatime = 0.0           # `time` keyword (input.cpp:463)
        self.variables.specials["time"] = lambda: self.deltatime
        self.variables.specials["nprocs"] = self._nprocs
        self._label_active = False
        self._labelstr = ""
        self._jump_skip = False
        self._jump_to: Optional[tuple] = None   # (filename-or-SELF, lines)
        self._path_prepend: Optional[str] = None
        self._path_substitute = 0
        # the ft/ journal (armed by MRTPU_JOURNAL) records every completed
        # command and checkpoints the named MRs; a resume replays the
        # recorded lines, skipping the first _ft_skip command executions
        # (builtins re-run so loop variables and jumps reproduce), then
        # restores the MRs from _ft_restore and goes on live
        from ..ft.journal import from_env as _ft_from_env
        self._ft_journal = _ft_from_env(script_mode=True)
        self._ft_skip = 0
        self._ft_restore: Optional[tuple] = None   # (ckpt record, dir)
        self._ft_resuming = False
        self._ft_resharded = False    # restored from another width
        self._ft_depth = 0
        self._ft_pending_begin: Optional[tuple] = None
        self.post_cmd: List = []

    def _nprocs(self) -> int:
        return getattr(self.obj.comm, "size", 1)

    def close(self):
        if self.logfile:
            self.logfile.close()
            self.logfile = None

    # -- output plumbing ---------------------------------------------------
    def _emit(self, text: str):
        if self.screen is not None:
            self.screen.write(text)
        if self.logfile is not None:
            self.logfile.write(text)

    def _echo(self, line: str):
        if self._label_active:
            return
        if self.echo_screen and self.screen is not None:
            self.screen.write(line + "\n")
        if self.echo_log and self.logfile is not None:
            self.logfile.write(line + "\n")

    # -- driving (reference Input::file / Input::one) ----------------------
    def run_file(self, filename: str):
        with open(filename) as f:
            lines = f.read().splitlines()
        self._run_script(lines, filename)

    def run_string(self, text: str):
        self._run_script(text.splitlines(), "<string>")

    def _run_script(self, lines: List[str], name: str):
        """The outermost run of an armed journal stages its lines as the
        ``begin`` record, written at the first non-builtin command: a
        script of builtins only (the one-line ``resume <dir>``) never
        writes a begin that would shadow the real script's.  ``include``
        runs never begin again."""
        if self._ft_journal is not None and self._ft_depth == 0 \
                and not self._ft_resuming:
            self._ft_pending_begin = (list(lines), name)
        self._ft_depth += 1
        try:
            if self._ft_depth == 1:
                # a top-level script is one request (obs/context.py): its
                # spans and journal records carry one trace id; an
                # enclosing context is kept, and include runs never
                # scope again
                from ..obs.context import ensure_scope
                with ensure_scope(label=f"oink:{name}"):
                    self._run_lines(lines)
            else:
                self._run_lines(lines)
        finally:
            self._ft_depth -= 1

    def _run_lines(self, lines: List[str]):
        i = 0
        while i < len(lines):
            line = lines[i]          # '&' continuation (input.cpp:117-126)
            while line.rstrip().endswith("&") and i + 1 < len(lines):
                line = line.rstrip()[:-1] + lines[i + 1]
                i += 1
            i += 1
            self.one(line)
            if self._jump_to is not None:
                target, tlines = self._jump_to
                self._jump_to = None
                if target == "SELF":
                    i = 0          # rewind (input.cpp:672)
                else:
                    self._run_lines(tlines)
                    return
        if self._label_active:
            raise MRError("Label wasn't found in input script")

    def one(self, line: str) -> Optional[str]:
        """Parse + execute one command line; returns the command word."""
        self._echo(line)
        stripped = _strip_comment(line)
        if not self._label_active:
            stripped = self._substitute(stripped)
        words = _split_args(stripped)
        if not words:
            return None
        command, args = words[0], words[1:]
        if self._label_active and command != "label":
            return None
        self._execute(command, args)
        return command

    def _substitute(self, s: str) -> str:
        """Quote-aware ``$x`` / ``${name}`` substitution."""
        out = []
        quote = ""
        i = 0
        while i < len(s):
            c = s[i]
            if c == "$" and not quote:
                if i + 1 < len(s) and s[i + 1] == "{":
                    j = s.find("}", i + 2)
                    if j < 0:
                        raise MRError("Invalid variable name")
                    name = s[i + 2:j]
                    i = j + 1
                else:
                    if i + 1 >= len(s):
                        raise MRError("Invalid variable name")
                    name = s[i + 1]
                    i += 2
                value = self.variables.retrieve(name)
                if value is None:
                    raise MRError(f"Substitution for illegal variable "
                                  f"{name!r}")
                out.append(value)
                continue
            if quote and c == quote:
                quote = ""
            elif not quote and c in "\"'":
                quote = c
            out.append(c)
            i += 1
        return "".join(out)

    # -- dispatch (reference Input::execute_command) -----------------------
    _BUILTINS = ("clear", "echo", "if", "include", "jump", "label", "log",
                 "next", "print", "shell", "variable", "input", "output",
                 "set", "mr", "resume")

    def _execute(self, command: str, args: List[str]):
        if command in self._BUILTINS:
            # a resume replays builtins, so loop variables and jumps
            # reproduce, but never `shell`: its file moves happened
            # before the checkpoint
            if self._ft_skip > 0 and command == "shell":
                return
            getattr(self, "cmd_" + command)(args)
            return
        if self._ft_skip > 0:
            # a resume skips the first _ft_skip command executions (they
            # are in the checkpoint), then restores the MRs.  Any
            # non-builtin word counts: a skipped command may be what
            # named the MR a later line dispatches on
            self._ft_skip -= 1
            if self._ft_skip == 0:
                self._ft_apply_restore()
            return
        # the begin lands before the first command starts: a crash in
        # command 1 still leaves a resumable journal
        self._ft_flush_begin()
        if command in COMMANDS:
            self._run_registered(command, args)
        elif command in self.obj.named:
            from ..obs import get_tracer
            t0 = _time.perf_counter()
            with get_tracer().span(f"oink.{command}", cat="oink",
                                   args=" ".join(args)):
                MRScriptDispatch(self.obj, self.variables).run(command,
                                                               args)
            self.deltatime = _time.perf_counter() - t0
        else:
            raise MRError(f"Unknown command: {command}")
        self._ft_cmd_done(command)

    def _ft_flush_begin(self):
        j = self._ft_journal
        if j is not None and self._ft_pending_begin is not None:
            lines, name = self._ft_pending_begin
            self._ft_pending_begin = None
            j.begin(lines, name)

    def _ft_cmd_done(self, command: str):
        """Journal one completed command (the record follows the fact)
        and checkpoint the named MRs every ``MRTPU_CKPT_EVERY``; then the
        command round's cancellation barrier (``obs/context.py``), with
        the checkpoint already durable."""
        j = self._ft_journal
        if j is not None:
            self._ft_flush_begin()
            j.cmd_done(command)
            j.maybe_checkpoint(self.obj)
        # post-command hooks run after the journal and checkpoint landed
        # (the serve/ mesh autoscaler promotes here); a raising hook is
        # dropped, never fatal
        for hook in list(self.post_cmd):
            try:
                hook(self)
            except Exception:
                if hook in self.post_cmd:
                    self.post_cmd.remove(hook)
        from ..obs.context import barrier_check
        barrier_check()

    def _ft_apply_restore(self):
        rec, self._ft_restore = self._ft_restore, None
        if rec:
            from ..ft.journal import restore_mrs
            ckpt, dir = rec
            restore_mrs(self.obj, ckpt, dir)

    def cmd_resume(self, args):
        """resume <dir>: replay the journal under <dir> from its last
        durable checkpoint into this interpreter (``ft/journal.py``)."""
        if len(args) != 1:
            raise MRError("Illegal resume command")
        from ..ft.journal import resume_into
        resume_into(self, args[0])

    def _run_registered(self, name: str, args: List[str]):
        """-i/-o switch split + params + run (input.cpp:429-468)."""
        iarg = 0
        while iarg < len(args) and args[iarg] not in ("-i", "-o"):
            iarg += 1
        params, rest = args[:iarg], args[iarg:]
        cmd = COMMANDS[name](self.obj, screen=self.screen
                             if self.screen is not None else False)
        cmd.params(params)
        i = 0
        ninput_args = 0
        while i < len(rest):
            j = i + 1
            while j < len(rest) and rest[j] not in ("-i", "-o"):
                j += 1
            if rest[i] == "-i":
                for a in rest[i + 1:j]:
                    self._add_input(a)
                ninput_args += j - i - 1
            else:
                pairs = rest[i + 1:j]
                if len(pairs) % 2:
                    raise MRError("Invalid command switch: -o takes "
                                  "file/name pairs")
                for k in range(0, len(pairs), 2):
                    f, n = pairs[k], pairs[k + 1]
                    self.obj.add_output(
                        path=None if f == "NULL"
                        else self._expandpath(f, output=True),
                        mr_name=None if n == "NULL" else n)
            i = j
        # one arg per input descriptor (command.cpp:21-27); a multi-file
        # input goes through a v_name variable
        if ninput_args and ninput_args != cmd.ninputs:
            raise MRError(
                f"Mismatch in command inputs: {name} takes "
                f"{cmd.ninputs}, got {ninput_args} (use a v_name "
                f"variable for a multi-file input)")
        from ..obs import get_tracer
        t0 = _time.perf_counter()
        try:
            # every script command is one span over its MR ops' spans
            with get_tracer().span(f"oink.{name}", cat="oink",
                                   args=" ".join(params)):
                cmd.run()
        finally:
            self.obj.cleanup()
        self.deltatime = _time.perf_counter() - t0

    def _expandpath(self, path: str, output: bool = False) -> str:
        """prepend + '%' substitution (reference expandpath,
        object.cpp:913-960): output paths always expand '%' to the proc
        id (0 on one device); input paths only under `set substitute`."""
        if output or self._path_substitute:
            path = path.replace("%", "0")
        if self._path_prepend:
            path = os.path.join(self._path_prepend, path)
        return path

    def _add_input(self, arg: str):
        """-i arg: a named MR, a v_name multi-path variable
        (object.cpp:450-462), or a path."""
        if arg in self.obj.named:
            self.obj.add_input(arg)
            return
        paths = expand_path_variable(self.variables, arg)
        if paths is not None:
            self.obj.add_input([self._expandpath(p) for p in paths])
            return
        self.obj.add_input(self._expandpath(arg))

    # -- builtins (reference input.cpp:497-796) ----------------------------
    def cmd_clear(self, args):
        if args:
            raise MRError("Illegal clear command")
        self.obj.cleanup()
        for name in list(self.obj.named):
            self.obj.delete_mr(name)
        defaults = dict(self.obj.defaults)
        pinned = dict(self.obj.pinned)
        self.obj = ObjectManager(self.obj.device, comm=self.obj.comm)
        # `set` defaults, and a serve/ tenant's pinned budget, survive
        self.obj.defaults.update(defaults)
        self.obj.pinned.update(pinned)

    def cmd_echo(self, args):
        modes = {"none": (False, False), "screen": (True, False),
                 "log": (False, True), "both": (True, True)}
        if len(args) != 1 or args[0] not in modes:
            raise MRError("Illegal echo command")
        self.echo_screen, self.echo_log = modes[args[0]]

    def cmd_if(self, args):
        """if "bool" then "cmd" ... elif "bool" "cmd" ... else "cmd" ...
        (input.cpp:527-640; each command is a quoted full line)."""
        if len(args) < 3 or args[1] != "then":
            raise MRError("Illegal if command")

        def block_end(start):
            j = start
            while j < len(args) and args[j] not in ("elif", "else"):
                j += 1
            return j

        cond = self.variables.evaluate_boolean(self._substitute(args[0]))
        first, last = 2, block_end(2)
        while True:
            if cond != 0.0:
                cmds = args[first:last]
                if not cmds:
                    raise MRError("Illegal if command")
                for c in cmds:
                    self.one(c)
                return
            if last >= len(args):
                return
            if args[last] == "elif":
                if last + 2 > len(args):
                    raise MRError("Illegal if command")
                cond = self.variables.evaluate_boolean(
                    self._substitute(args[last + 1]))
                first = last + 2
            else:  # else
                cond = 1.0
                first = last + 1
            last = block_end(first)

    def cmd_include(self, args):
        if len(args) != 1:
            raise MRError("Illegal include command")
        self.run_file(args[0])

    def cmd_jump(self, args):
        if not 1 <= len(args) <= 2:
            raise MRError("Illegal jump command")
        if self._jump_skip:
            self._jump_skip = False
            return
        if len(args) == 2:
            self._label_active = True
            self._labelstr = args[1]
        if args[0] == "SELF":
            self._jump_to = ("SELF", None)
        else:
            with open(args[0]) as f:
                self._jump_to = (args[0], f.read().splitlines())

    def cmd_label(self, args):
        if len(args) != 1:
            raise MRError("Illegal label command")
        if self._label_active and self._labelstr == args[0]:
            self._label_active = False

    def cmd_log(self, args):
        if len(args) != 1:
            raise MRError("Illegal log command")
        if self.logfile:
            self.logfile.close()
        self.logfile = None if args[0] == "none" else open(args[0], "w")

    def cmd_next(self, args):
        if self.variables.next(args):
            self._jump_skip = True

    def cmd_print(self, args):
        if len(args) != 1:
            raise MRError("Illegal print command")
        self._emit(self._substitute(args[0]) + " \n")

    def cmd_shell(self, args):
        """The reference's restricted verbs cd, mkdir, mv, rm and rmdir,
        as library calls, never a system() (input.cpp:751-791)."""
        if not args:
            raise MRError("Illegal shell command")
        verb, rest = args[0], args[1:]
        if verb == "cd" and len(rest) == 1:
            os.chdir(rest[0])
        elif verb == "mkdir" and rest:
            for d in rest:
                os.makedirs(d, exist_ok=True)
        elif verb == "mv" and len(rest) == 2:
            shutil.move(rest[0], rest[1])
        elif verb in ("rm", "rmdir") and rest:
            remove = os.unlink if verb == "rm" else os.rmdir
            for f in rest:
                try:
                    remove(f)
                except FileNotFoundError:
                    pass
        else:
            raise MRError("Illegal shell command")

    def cmd_variable(self, args):
        self.variables.set(args)

    def cmd_mr(self, args):
        """mr ID [verbosity [timer [memsize [outofcore]]]]
        (object.cpp add_mr): a named MR with the manager's defaults."""
        if not 1 <= len(args) <= 5:
            raise MRError("Illegal mr command")
        name = args[0]
        if not all(c.isalnum() or c == "_" for c in name):
            raise MRError("MR ID must be alphanumeric or underscore "
                          "characters")
        if name in self.obj.named:
            raise MRError("ID in mr command is already in use")
        mr = self.obj.create_mr()
        for key, val in zip(("verbosity", "timer", "memsize", "outofcore"),
                            args[1:]):
            mr.set(**{key: int(val)})
        self.obj.name_mr(name, mr)

    def cmd_set(self, args):
        """set keyword value ... (object.cpp Object::set): MR defaults
        (``scratch`` sets the spill directory ``fpath``, ``onfault`` is
        string-valued), and ``prepend``/``substitute`` for -i/-o path
        resolution."""
        if len(args) % 2:
            raise MRError("Illegal set command")
        for i in range(0, len(args), 2):
            key, val = args[i], args[i + 1]
            if key == "scratch":              # the spill directory
                self.obj.set_default("fpath", val)
            elif key == "onfault":            # string-valued
                self.obj.set_default("onfault", val)
            elif key == "prepend":
                root = getattr(self, "_path_root", None)
                if root is not None:
                    # a serve/ session roots relative output in its own
                    # directory; an absolute prepend would move -o files
                    # out of the session's result, so it fails loudly
                    if os.path.isabs(val):
                        raise MRError(
                            "absolute prepend is pinned by the server "
                            "(session outputs stay in the session "
                            "directory; doc/serve.md)")
                    val = os.path.join(root, val)
                self._path_prepend = val
            elif key == "substitute":
                self._path_substitute = int(val)
            else:
                self.obj.set_default(key, int(val))

    def cmd_input(self, args):
        """input N keyword value ... — per-slot descriptor settings,
        stored (only the byte-chunk map variants of the reference read
        them)."""
        if len(args) < 3:
            raise MRError("Illegal input command")
        self.obj.input_settings[int(args[0])] = dict(zip(args[1::2],
                                                         args[2::2]))

    def cmd_output(self, args):
        """output N keyword value ... — stored, as for ``input``."""
        if len(args) < 3:
            raise MRError("Illegal output command")
        self.obj.output_settings[int(args[0])] = dict(zip(args[1::2],
                                                          args[2::2]))


# ---------------------------------------------------------------------------
# line chopping helpers (reference Input::parse)
# ---------------------------------------------------------------------------

def _strip_comment(line: str) -> str:
    quote = ""
    for i, c in enumerate(line):
        if c == "#" and not quote:
            return line[:i]
        if quote and c == quote:
            quote = ""
        elif not quote and c in "\"'":
            quote = c
    return line


def _split_args(line: str) -> List[str]:
    """Whitespace split with single/double-quoted strings as one arg
    (input.cpp:289-321)."""
    out: List[str] = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n:
            break
        if line[i] in "\"'":
            q = line[i]
            j = line.find(q, i + 1)
            if j < 0:
                raise MRError("Unbalanced quotes in input line")
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            out.append(line[i:j])
            i = j
    return out


# ---------------------------------------------------------------------------
# command line front end (reference oink/oink.cpp switches)
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    """``python -m gpu_mapreduce_tpu_torch.oink.script [-in file]
    [-log file|none] [-screen file|none] [-echo style] [-partition NxM
    ...] [-var name value...] [-device cpu|cuda]`` (reference
    oink.cpp:45-125).  The script runs on the card unless ``-device cpu``
    is given; under ``-partition`` the specs' procs are shards of one
    mesh on that device (one a card where there are enough cards)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    infile = None
    logname: Optional[str] = "log.oink"
    lograw: Optional[str] = None      # the explicit -log value, if any
    screen: object = None
    screenraw: Optional[str] = None
    echo = None
    device = None
    partition: List[str] = []
    varsets = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-in", "-i"):
            infile = argv[i + 1]
            i += 2
        elif a in ("-log", "-l"):
            lograw = argv[i + 1]
            logname = None if lograw == "none" else lograw
            i += 2
        elif a in ("-screen", "-sc"):
            screenraw = argv[i + 1]      # opened only without -partition
            i += 2
        elif a in ("-echo", "-e"):
            echo = argv[i + 1]
            i += 2
        elif a in ("-device", "-d"):
            device = argv[i + 1]
            i += 2
        elif a in ("-var", "-v"):
            name = argv[i + 1]
            vals = []
            i += 2
            while i < len(argv) and not argv[i].startswith("-"):
                vals.append(argv[i])
                i += 1
            varsets.append((name, vals))
        elif a in ("-partition", "-p"):
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                partition.append(argv[i])
                i += 1
            if not partition:
                raise SystemExit("Invalid command-line argument: "
                                 "-partition needs world specs")
        else:
            raise SystemExit(f"Invalid command-line argument: {a}")
    if partition:
        # a multi-world run (the reference requires -in, oink.cpp:99-100)
        if not infile:
            raise SystemExit("Must use -in switch with multiple partitions")
        from .universe import run_universe
        run_universe(infile, partition,
                     comm=_partition_mesh(partition, device),
                     logname=lograw, screenname=screenraw, echo=echo,
                     varsets=varsets, device=device)
        return 0
    if screenraw is not None:
        screen = False if screenraw == "none" else open(screenraw, "w")
    interp = OinkScript(device=device, screen=screen, logfile=logname)
    if echo:
        interp.cmd_echo([echo])
    for name, vals in varsets:
        interp.variables.set([name, "index"] + vals)
    try:
        if infile:
            interp.run_file(infile)
        else:
            interp.run_string(sys.stdin.read())
    finally:
        interp.close()
    return 0


def _partition_mesh(specs: List[str], device):
    """The mesh the partition specs split: as many shards as their procs
    sum to (None for one), one a CUDA card when that many are present,
    else all on ``device`` (the card unless ``"cpu"``)."""
    from ..parallel.mesh import mesh_on
    from .universe import Universe
    probe = Universe(0)
    for spec in specs:
        probe.add_world(spec)
    total = sum(probe.procs_per_world)
    return mesh_on(total, device) if total > 1 else None


if __name__ == "__main__":
    raise SystemExit(main())
