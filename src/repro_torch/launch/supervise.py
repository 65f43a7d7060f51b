"""Process-level restart supervisor for the serving launcher (copy of
``repro.launch.supervise``).

``--supervise`` on ``repro_torch.launch.serve`` runs the launcher as a
CHILD process under this loop. An injected ``die`` fault (``--inject
die:step=5``) hard-kills the child mid-step with
:data:`~repro_torch.runtime.faults.DIE_EXIT_CODE`; the supervisor restarts
it with the ``die`` injector stripped (the step counter restarts with the
process, so a pinned kill would fire again forever), and the restarted
child replays its write-ahead journal (``--journal``) to finish every
request exactly once. On the card the restarted process builds its CUDA
graphs from nothing.

Any other non-zero exit is a real failure and propagates; a ``die`` fault
that was armed but never fired fails the run too.
"""
from __future__ import annotations

import subprocess
import sys
from typing import Callable

from repro_torch.runtime.faults import DIE_EXIT_CODE

MAX_RESTARTS = 5


def _spec_kind(spec: str) -> str:
    return spec.split(":", 1)[0].strip()


def die_armed(argv: list) -> bool:
    """True if the argv arms at least one ``die`` injector."""
    return any(_spec_kind(s) == "die" for s in inject_specs(argv))


def inject_specs(argv: list) -> list:
    """The fault specs an ``--inject``-style argv arms."""
    out, grab = [], False
    for a in argv:
        if grab:
            out.append(a)
            grab = False
        elif a == "--inject":
            grab = True
        elif a.startswith("--inject="):
            out.append(a[len("--inject="):])
    return out


def strip_die(argv: list) -> list:
    """Argv with every ``--inject die:...`` pair or flag removed."""
    out, grab = [], False
    for a in argv:
        if grab:
            grab = False
            if _spec_kind(a) == "die":
                out.pop()               # drop the preceding --inject
                continue
            out.append(a)
        elif a == "--inject":
            out.append(a)
            grab = True
        elif (a.startswith("--inject=")
              and _spec_kind(a[len("--inject="):]) == "die"):
            continue
        else:
            out.append(a)
    return out


def supervise(module: str, child_argv: list, *,
              max_restarts: int = MAX_RESTARTS,
              log: Callable[[str], None] = print) -> int:
    """Run ``python -m module child_argv`` under the restart loop; return
    the number of restarts. Raises SystemExit on a real (non-``die``)
    child failure, on restart exhaustion, and on a ``die`` injector that
    never fired."""
    armed = die_armed(child_argv)
    restarts = 0
    argv = list(child_argv)
    while True:
        rc = subprocess.call([sys.executable, "-m", module] + argv)
        if rc == DIE_EXIT_CODE:
            if restarts >= max_restarts:
                raise SystemExit(f"[supervise] FAILED: {restarts} restarts "
                                 f"exhausted and the child still dies")
            restarts += 1
            argv = strip_die(argv)
            log(f"[supervise] child hard-killed (injected die, exit {rc}); "
                f"restart #{restarts} with die injector stripped")
            continue
        break
    if armed and restarts < 1:
        raise SystemExit("[supervise] FAILED: a die fault was armed but the "
                         "child never died — the chaos smoke proved nothing")
    if rc != 0:
        raise SystemExit(rc)
    log(f"[supervise] child exited 0 after {restarts} restart(s)")
    return restarts
