"""The OINK input-script interpreter.

The counterpart of ``gpu_mapreduce_tpu/oink/script.py`` (reference
``oink/input.{h,cpp}``): a line reader with ``&`` continuation,
quote-aware ``#`` comments and ``$x``/``${x}`` substitution; the builtins
clear, echo, if, include, jump, label, log, next, print and variable; the
OINK commands input, output and set; registered commands with ``-i``/``-o``
switches; and the ``oink.cpp`` command line (``-in``, ``-log``,
``-screen``, ``-echo``, ``-var``).

Every MR a script makes lives on its ``ObjectManager``'s device: the card
unless the caller passes ``device="cpu"``.  Not ported yet (each raises
``MRError``): the ``mr`` builtin and named-MR method lines (the JAX
package's ``mrscript.py``), ``shell``, the ft journal's ``resume``, and
multi-world runs (``-partition``).
"""

from __future__ import annotations

import os
import sys
import time as _time
from typing import List, Optional, TextIO

from ..core.runtime import MRError
from . import commands  # noqa: F401  (registers the ported commands)
from .command import COMMANDS
from .objects import ObjectManager
from .variables import Variables

_NOT_PORTED = {"mr": "the mr builtin", "shell": "the shell builtin",
               "resume": "the ft journal's resume"}


class OinkScript:
    """One interpreter: variable table + object manager + log.

    ``device``: where every MR of the script lives (None → the card).
    ``screen``: None → stdout, False → silent, or a file-like."""

    def __init__(self, device=None, screen=None,
                 logfile: Optional[str] = None):
        self.obj = ObjectManager(device)
        self.variables = Variables()
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
        self.variables.specials["nprocs"] = lambda: 1
        self._label_active = False
        self._labelstr = ""
        self._jump_skip = False
        self._jump_to: Optional[tuple] = None   # (filename-or-SELF, lines)
        self._path_prepend: Optional[str] = None
        self._path_substitute = 0

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
            self._run_lines(f.read().splitlines())

    def run_string(self, text: str):
        self._run_lines(text.splitlines())

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
                 "next", "print", "variable", "input", "output", "set")

    def _execute(self, command: str, args: List[str]):
        if command in self._BUILTINS:
            getattr(self, "cmd_" + command)(args)
        elif command in COMMANDS:
            self._run_registered(command, args)
        elif command in _NOT_PORTED:
            raise MRError(f"{_NOT_PORTED[command]} is not ported yet")
        elif command in self.obj.named:
            raise MRError(f"named-MR commands ({command} ...) are not "
                          f"ported yet")
        else:
            raise MRError(f"Unknown command: {command}")

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
        t0 = _time.perf_counter()
        try:
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
        vname = arg[2:] if arg.startswith("v_") else None
        if vname is not None and self.variables.find(vname) is not None:
            if self.variables.equal_style(vname):
                raise MRError("Command input is equal-style variable")
            n = self.variables.retrieve_count(vname)
            self.obj.add_input([
                self._expandpath(self.variables.retrieve_single(vname, i))
                for i in range(n)])
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
        self.obj = ObjectManager(self.obj.device)
        self.obj.defaults.update(defaults)    # `set` defaults survive

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

    def cmd_variable(self, args):
        self.variables.set(args)

    def cmd_set(self, args):
        """set keyword value ... (object.cpp Object::set): MR defaults,
        and ``prepend``/``substitute`` for -i/-o path resolution."""
        if len(args) % 2:
            raise MRError("Illegal set command")
        for i in range(0, len(args), 2):
            key, val = args[i], args[i + 1]
            if key == "prepend":
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
    [-log file|none] [-screen file|none] [-echo style] [-var name
    value...] [-device cpu|cuda]`` (reference oink.cpp:45-125).  The
    script runs on the card unless ``-device cpu`` is given."""
    argv = list(sys.argv[1:] if argv is None else argv)
    infile = None
    logname: Optional[str] = "log.oink"
    screen: object = None
    echo = None
    device = None
    varsets = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-in", "-i"):
            infile = argv[i + 1]
            i += 2
        elif a in ("-log", "-l"):
            logname = None if argv[i + 1] == "none" else argv[i + 1]
            i += 2
        elif a in ("-screen", "-sc"):
            screen = False if argv[i + 1] == "none" \
                else open(argv[i + 1], "w")
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
            raise SystemExit("-partition (multi-world runs) is not ported "
                             "yet")
        else:
            raise SystemExit(f"Invalid command-line argument: {a}")
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


if __name__ == "__main__":
    raise SystemExit(main())
