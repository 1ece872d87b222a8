"""Script variables: the LAMMPS-style variable engine of OINK.

The counterpart of ``gpu_mapreduce_tpu/oink/variables.py`` (reference
``oink/variable.{h,cpp}``): styles INDEX/LOOP/WORLD/UNIVERSE/ULOOP/STRING/
EQUAL, ``retrieve()`` (the string a ``$x`` substitutes), ``next()``
(advance loop variables, signalling exhaustion for the jump/next idiom)
and the EQUAL-style formula evaluator with C-like precedence, math
functions and the ``time``/``nprocs`` specials, as a recursive-descent
parser over tokens (no ``eval()``).

WORLD/UNIVERSE/ULOOP are the multi-world styles of ``-partition`` runs
(``universe.py``).  The reference coordinates ULOOP through a lock file
on shared disk (``variable.cpp:186-240``, ``:345-383``); here worlds are
threads of one process, so a :class:`WorldContext` carries the world's
index and count and a :class:`UloopCounter` shared by the universe's
worlds hands out the next index under a lock.  Without a context the
table runs one world (iworld 0, nworlds 1): UNIVERSE/ULOOP start at 0 and
each ``next`` claims 1, 2, ... as LOOP does.
"""

from __future__ import annotations

import math
import random as _random
import re
import threading
from typing import Callable, Dict, List, Optional

from ..core.runtime import MRError

_STYLES = ("index", "loop", "world", "universe", "uloop", "string", "equal")


class WorldContext:
    """This world's place in the universe (reference Universe fields
    ``iworld``/``nworlds`` + the ``tmp.oink.variable`` lock file).

    One instance per world; ``counter`` is SHARED between the worlds of
    one universe (the runner passes the same object to all).  The
    counter starts at ``nworlds`` — world i implicitly owns index i, the
    first ``next`` anywhere claims ``nworlds``, exactly the number the
    reference seeds its lock file with (``variable.cpp:215-219``)."""

    def __init__(self, iworld: int = 0, nworlds: int = 1,
                 counter: Optional["UloopCounter"] = None,
                 on_advance: Optional[Callable[[int, int], None]] = None):
        self.iworld = iworld
        self.nworlds = nworlds
        self.counter = counter if counter is not None \
            else UloopCounter(nworlds)
        self.on_advance = on_advance   # (nextindex, iworld) → universe log

    def uloop_next(self) -> int:
        nextindex = self.counter.claim()
        if self.on_advance is not None:
            self.on_advance(nextindex, self.iworld)
        return nextindex

    def uloop_seed(self, name: str, generation: int):
        """(Re)seed the shared counter at variable definition so a
        SECOND uloop loop later in the script starts fresh instead of
        resuming the exhausted counter (the reference rewrites its lock
        file with nworlds at every definition, variable.cpp:215-219).

        Reseeding is once per (variable, definition-generation): the
        FIRST world to define it wins, later worlds' definitions are
        no-ops — unlike a naive proc-0 reset, a straggler world defining
        the variable after others already claimed indices cannot rewind
        the counter and hand an index out twice."""
        self.counter.seed(name, generation, self.nworlds)


class UloopCounter:
    """The shared next-index source (the reference's lock file, made a
    mutex: rename()-as-lock → threading.Lock, variable.cpp:350-366)."""

    def __init__(self, start: int):
        self._next = start
        self._lock = threading.Lock()
        self._gens: Dict[str, int] = {}   # var name → seeded generation

    def claim(self) -> int:
        with self._lock:
            n = self._next
            self._next += 1
            return n

    def seed(self, name: str, generation: int, start: int):
        """Reset to ``start`` the first time (name, generation) is seen;
        the same definition executed by the other worlds is a no-op."""
        with self._lock:
            if self._gens.get(name, 0) < generation:
                self._gens[name] = generation
                self._next = start


class _Var:
    def __init__(self, style: str, values: List[str], which: int = 0,
                 offset: int = 0, pad: int = 0):
        self.style = style
        self.values = values          # INDEX/WORLD/UNIVERSE/STRING: strings
        self.num = len(values)        # LOOP/ULOOP: overridden below
        self.which = which
        self.offset = offset
        self.pad = pad


class _Var:
    def __init__(self, style: str, values: List[str], which: int = 0,
                 offset: int = 0, pad: int = 0):
        self.style = style
        self.values = values          # INDEX/WORLD/UNIVERSE/STRING: strings
        self.num = len(values)        # LOOP/ULOOP: overridden below
        self.which = which
        self.offset = offset
        self.pad = pad


class Variables:
    """The variable table; one per interpreter (reference Variable class).

    ``specials`` maps EQUAL keywords to zero-arg callables — the
    interpreter installs ``time`` (elapsed seconds of the last command,
    ``oink/input.cpp:458-464``) and ``nprocs``."""

    def __init__(self, world: Optional[WorldContext] = None):
        self._vars: Dict[str, _Var] = {}
        self.specials: Dict[str, Callable[[], float]] = {}
        self._rng: Optional[_random.Random] = None
        self.world = world if world is not None else WorldContext()
        self._uni_gen: Dict[str, int] = {}  # this table's definition count

    # -- the `variable` command (reference Variable::set) ------------------
    def set(self, args: List[str]):
        if len(args) < 2:
            raise MRError("Illegal variable command")
        name, style = args[0], args[1]
        if style == "delete":
            if len(args) != 2:
                raise MRError("Illegal variable command")
            self._vars.pop(name, None)
            return
        if style not in _STYLES:
            raise MRError(f"Illegal variable command: unknown style "
                          f"{style!r}")
        if name in self._vars:
            old = self._vars[name].style
            if style in ("string", "equal"):
                # STRING/EQUAL may be reset in place (variable.cpp:228-259)
                if old != style:
                    raise MRError("Cannot redefine variable as a "
                                  "different style")
            else:
                return  # INDEX/LOOP/...: first definition wins

        if style in ("index", "world", "universe"):
            if len(args) < 3:
                raise MRError("Illegal variable command")
            v = _Var(style, args[2:])
            if style == "world":
                # one value per partition (variable.cpp:166-168)
                if v.num != self.world.nworlds:
                    raise MRError("World variable count doesn't match # "
                                  "of partitions")
                v.which = self.world.iworld
            elif style == "universe":
                if v.num < self.world.nworlds:
                    raise MRError("Universe/uloop variable count < # of "
                                  "partitions")
                v.which = self.world.iworld
                self._check_uni_lengths(v)
                self._seed_uni(name)
        elif style in ("loop", "uloop"):
            rest = args[2:]
            pad = 0
            if rest and rest[-1] == "pad":
                rest = rest[:-1]
                pad = 1
            if len(rest) == 1:
                # ULOOP is 0-based in the reference (offset stays 0,
                # variable.cpp:196-201 + retrieve :405-407); LOOP is
                # 1-based (offset = nfirst = 1, :128-134)
                nfirst, nlast = (0, int(rest[0]) - 1) \
                    if style == "uloop" else (1, int(rest[0]))
            elif len(rest) == 2 and style == "loop":
                nfirst, nlast = int(rest[0]), int(rest[1])
            else:
                raise MRError("Illegal variable command")
            if nfirst > nlast or nlast < 0 or \
                    (style == "loop" and nlast <= 0):
                raise MRError("Illegal variable command")
            # pad width: digits of N (for uloop the count, variable.cpp
            # :203-206; for loop the last value, :135-141)
            v = _Var(style, [], offset=nfirst,
                     pad=len(str(nlast + 1 if style == "uloop" else nlast))
                     if pad else 0)
            v.num = nlast - nfirst + 1
            if style == "uloop":
                if v.num < self.world.nworlds:
                    raise MRError("Universe/uloop variable count < # of "
                                  "partitions")
                v.which = self.world.iworld
                self._check_uni_lengths(v)
                self._seed_uni(name)
        elif style == "string":
            if len(args) != 3:
                raise MRError("Illegal variable command")
            v = _Var(style, [args[2]])
        else:  # equal
            if len(args) != 3:
                raise MRError("Illegal variable command")
            v = _Var(style, [args[2]])
        self._vars[name] = v

    def _seed_uni(self, name: str):
        """A universe/uloop definition reseeds the shared counter (the
        reference rewrites its lock file at every definition,
        variable.cpp:215-219): this table's Nth definition of ``name``
        is shared generation N, and only the first world to reach it
        reseeds."""
        self._uni_gen[name] = self._uni_gen.get(name, 0) + 1
        self.world.uloop_seed(name, self._uni_gen[name])

    def _check_uni_lengths(self, v: _Var):
        """All universe/uloop variables must agree on num (they advance
        in lockstep off one counter — variable.cpp:221-224)."""
        for other in self._vars.values():
            if other is not v and other.style in ("universe", "uloop") \
                    and other.num != v.num:
                raise MRError("All universe/uloop variables must have "
                              "same # of values")

    # -- retrieval (reference Variable::retrieve) ---------------------------
    def find(self, name: str) -> Optional[_Var]:
        return self._vars.get(name)

    def retrieve(self, name: str) -> Optional[str]:
        v = self._vars.get(name)
        if v is None or v.which >= v.num:
            return None
        if v.style in ("index", "world", "universe", "string"):
            return v.values[v.which]
        if v.style in ("loop", "uloop"):
            n = v.which + v.offset
            return f"{n:0{v.pad}d}" if v.pad else str(n)
        # equal: evaluate on every retrieval (reference %.10g format)
        return f"{self.evaluate(v.values[0]):.10g}"

    def retrieve_count(self, name: str) -> int:
        v = self._vars.get(name)
        if v is None:
            raise MRError(f"variable {name!r} is unknown")
        return v.num

    def retrieve_single(self, name: str, nth: int) -> str:
        v = self._vars[name]
        if v.style in ("index", "world", "universe", "string"):
            return v.values[nth]
        n = nth + v.offset
        return f"{n:0{v.pad}d}" if v.pad else str(n)

    def equal_style(self, name: str) -> bool:
        v = self._vars.get(name)
        return v is not None and v.style == "equal"

    # -- the `next` command (reference Variable::next) ----------------------
    def next(self, names: List[str]) -> bool:
        """Advance the listed loop variables.  Returns True when any is
        exhausted (the variable is removed and the caller skips its next
        jump — input.cpp:726-728)."""
        if not names:
            raise MRError("Illegal next command")
        styles = set()
        for n in names:
            v = self._vars.get(n)
            if v is None:
                raise MRError("Invalid variable in next command")
            styles.add("uni" if v.style in ("universe", "uloop")
                       else v.style)
        if len(styles) > 1:
            raise MRError("All variables in next command must be same "
                          "style")
        style = styles.pop()
        if style in ("string", "equal", "world"):
            raise MRError("Invalid variable style with next command")
        exhausted = False
        if style == "uni":
            # claim the next unprocessed index from the universe's shared
            # counter; every listed variable jumps to it
            # (variable.cpp:345-383)
            nextindex = self.world.uloop_next()
            for n in names:
                v = self._vars[n]
                v.which = nextindex
                if v.which >= v.num:
                    exhausted = True
                    del self._vars[n]
            return exhausted
        for n in names:
            v = self._vars[n]
            v.which += 1
            if v.which >= v.num:
                exhausted = True
                del self._vars[n]
        return exhausted

    # ------------------------------------------------------------------
    # EQUAL-style formula evaluation (reference variable.cpp:560-1010)
    # grammar: || < && < == != < < <= > >= < + - < * / < ^ < unary -/!
    # operands: number, PI, time, nprocs, v_name, fn(args...), (expr)
    # ------------------------------------------------------------------

    _TOKEN_RE = re.compile(r"""
        \s*(?:
          (?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
        | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
        | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/^()!<>,])
        )""", re.VERBOSE)

    _FUNCS = {
        "sqrt": (1, math.sqrt), "exp": (1, math.exp),
        "ln": (1, math.log), "log": (1, math.log10),
        "sin": (1, math.sin), "cos": (1, math.cos),
        "tan": (1, math.tan), "asin": (1, math.asin),
        "acos": (1, math.acos), "atan": (1, math.atan),
        "atan2": (2, math.atan2), "ceil": (1, math.ceil),
        "floor": (1, math.floor),
        "round": (1, lambda a: math.ceil(a) if a - math.floor(a) >= 0.5
                  else math.floor(a)),          # MYROUND, variable.cpp:29
    }

    def _tokens(self, s: str) -> List[str]:
        out, pos = [], 0
        while pos < len(s):
            m = self._TOKEN_RE.match(s, pos)
            if m is None:
                if s[pos:].strip() == "":
                    break
                raise MRError(f"Invalid syntax in variable formula: "
                              f"{s[pos:]!r}")
            out.append(m.group("num") or m.group("name") or m.group("op"))
            pos = m.end()
        return out

    def evaluate(self, formula: str) -> float:
        toks = self._tokens(formula)
        pos = [0]

        def peek():
            return toks[pos[0]] if pos[0] < len(toks) else None

        def take():
            t = peek()
            pos[0] += 1
            return t

        def expect(t):
            if take() != t:
                raise MRError(f"Expected {t!r} in variable formula")

        def atom() -> float:
            t = take()
            if t is None:
                raise MRError("Invalid variable formula")
            if t == "(":
                v = or_expr()
                expect(")")
                return v
            if t == "-":
                return -atom()
            if t == "!":
                return 0.0 if atom() != 0.0 else 1.0
            if t[0].isdigit() or t[0] == ".":
                return float(t)
            if t == "PI":
                return math.pi
            if t in self.specials:
                return float(self.specials[t]())
            if t in ("random", "normal"):
                expect("(")
                a = or_expr(); expect(",")
                b = or_expr(); expect(",")
                c = or_expr(); expect(")")
                if self._rng is None:
                    self._rng = _random.Random(int(c))
                return (self._rng.uniform(a, b) if t == "random"
                        else b * self._rng.gauss(0.0, 1.0) + a)
            if t in self._FUNCS:
                nargs, fn = self._FUNCS[t]
                expect("(")
                args = [or_expr()]
                for _ in range(nargs - 1):
                    expect(",")
                    args.append(or_expr())
                expect(")")
                return float(fn(*args))
            if t.startswith("v_"):
                val = self.retrieve(t[2:])
                if val is None:
                    raise MRError(f"Invalid variable reference {t!r} in "
                                  f"variable formula")
                return float(val)
            raise MRError(f"Invalid keyword {t!r} in variable formula")

        def power() -> float:
            v = atom()
            if peek() == "^":           # right-associative
                take()
                return v ** power()
            return v

        def _level(sub, ops) -> float:
            v = sub()
            while peek() in ops:
                op = take()
                r = sub()
                v = ops[op](v, r)
            return v

        def mul_expr():
            return _level(power, {"*": lambda a, b: a * b,
                                  "/": lambda a, b: a / b})

        def add_expr():
            return _level(mul_expr, {"+": lambda a, b: a + b,
                                     "-": lambda a, b: a - b})

        def cmp_expr():
            return _level(add_expr, {
                "<": lambda a, b: float(a < b),
                "<=": lambda a, b: float(a <= b),
                ">": lambda a, b: float(a > b),
                ">=": lambda a, b: float(a >= b)})

        def eq_expr():
            return _level(cmp_expr, {"==": lambda a, b: float(a == b),
                                     "!=": lambda a, b: float(a != b)})

        def and_expr():
            return _level(eq_expr,
                          {"&&": lambda a, b: float(bool(a) and bool(b))})

        def or_expr():
            return _level(and_expr,
                          {"||": lambda a, b: float(bool(a) or bool(b))})

        try:
            result = or_expr()
        except (ZeroDivisionError, OverflowError, ValueError) as e:
            raise MRError(f"Error in variable formula {formula!r}: {e}")
        if peek() is not None:
            raise MRError(f"Invalid variable formula {formula!r}")
        return result

    def evaluate_boolean(self, s: str) -> float:
        return self.evaluate(s)
