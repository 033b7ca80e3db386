"""Workflow engine: multi-step pipelines with checkpoint/resume.

The reference runs workflows as embedded POSIX-sh scripts re-invoking the
binary per step, resuming via `notExists "$OUT.dbtype"` guards
(data/workflow/blastp.sh:38,59-80,
 src/commons/CommandCaller.cpp:70-80).

Redesign: steps are in-process Python calls (no execve, no
serialization through environment variables), but the same on-disk
`.dbtype`-guard resumability is preserved so an interrupted run picks up
after the last finished step.
"""

import os
import shutil
import time

from ..params import Params
from ..utils import log


# wall seconds of every step run through Workflow.step, by command name,
# summed until the caller clears the dict
STEP_SECONDS = {}


def not_exists(db_path: str) -> bool:
    return not os.path.exists(db_path + ".dbtype")


class Workflow:
    def __init__(self, tmp_dir: str, force_reuse: bool = False):
        self.tmp = tmp_dir
        os.makedirs(tmp_dir, exist_ok=True)
        self.force_reuse = force_reuse

    def path(self, name: str) -> str:
        return os.path.join(self.tmp, name)

    def step(self, out_db: str, command_name: str, args, par: Params = None):
        """Run one command unless `out_db.dbtype` already exists."""
        if not not_exists(out_db) and not self.force_reuse:
            log.info(f"Skipping {command_name}: {out_db} exists")
            return
        from ..registry import get_command
        cmd = get_command(command_name)
        if cmd is None:
            raise KeyError(f"unknown command {command_name}")
        sub = Params().parse([str(a) for a in args], cmd, cmd.min_db,
                             cmd.max_db)
        if par is not None:
            # inherit explicitly-set parent flags that the child didn't set
            for attr in par._was_set:
                if attr not in sub._was_set:
                    sub.set(attr, getattr(par, attr))
        fn = cmd.load()
        timer = log.Timer()
        t0 = time.perf_counter()
        ret = fn(sub, cmd)
        STEP_SECONDS[command_name] = (STEP_SECONDS.get(command_name, 0.0)
                                      + time.perf_counter() - t0)
        log.info(f"[workflow] {command_name} -> "
                 f"{os.path.basename(out_db)}: {timer}")
        if ret not in (0, None):
            raise RuntimeError(f"step {command_name} failed with {ret}")

    def cleanup(self, remove: bool):
        if remove and os.path.isdir(self.tmp):
            shutil.rmtree(self.tmp, ignore_errors=True)

    def step_always(self, command_name: str, args, par=None):
        """Run one command unconditionally (for steps whose outputs are
        plain files without .dbtype markers)."""
        from ..registry import get_command
        cmd = get_command(command_name)
        if cmd is None:
            raise KeyError(f"unknown command {command_name}")
        sub = Params().parse([str(a) for a in args], cmd, cmd.min_db,
                             cmd.max_db)
        if par is not None:
            for attr in par._was_set:
                if attr not in sub._was_set:
                    sub.set(attr, getattr(par, attr))
        fn = cmd.load()
        ret = fn(sub, cmd)
        if ret not in (0, None):
            raise RuntimeError(f"step {command_name} failed with {ret}")
