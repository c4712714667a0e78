"""Local ranks of one command, as ``torchrun`` starts them, bounded in time.

``LocalRanks(cmd, procs)`` starts ``procs`` copies of ``cmd`` with
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` (127.0.0.1) and
``MASTER_PORT`` (a free port) set, each one's output in a file of its own
(no pipe can fill and block a child). ``wait(timeout_s)`` returns their
outputs when all exit 0; as soon as one exits non-zero, or when the time
runs out, it kills the others and raises ``RankFailure`` with the tails of
their output. Leaving the ``with`` block kills and reaps every child that
still runs, so no rank outlives its caller.
"""

import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["LocalRanks", "RankFailure", "free_port"]


class RankFailure(RuntimeError):
    """A rank exited non-zero or did not finish in time."""


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalRanks:
    def __init__(self, cmd: Sequence[str], procs: int,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None):
        self._dir = tempfile.TemporaryDirectory(prefix="vwfd_ranks_")
        base = dict(os.environ if env is None else env,
                    WORLD_SIZE=str(procs), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port()))
        self.procs: List[subprocess.Popen] = []
        self._files = []
        try:
            for r in range(procs):
                out = open(os.path.join(self._dir.name, f"{r}.out"), "w+")
                err = open(os.path.join(self._dir.name, f"{r}.err"), "w+")
                self._files.append((out, err))
                self.procs.append(subprocess.Popen(
                    list(cmd), cwd=cwd, stdout=out, stderr=err,
                    stdin=subprocess.DEVNULL,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        except BaseException:
            self.close()
            raise

    def _read(self, r: int, which: int) -> str:
        f = self._files[r][which]
        f.flush()
        f.seek(0)
        return f.read()

    def _tails(self) -> str:
        return "\n".join(
            f"rank {r} (rc {p.poll()}): {self._read(r, 1)[-2000:]}"
            for r, p in enumerate(self.procs))

    def wait(self, timeout_s: float) -> List[str]:
        """Every rank's standard output once all have exited 0; raises
        ``RankFailure`` (the others killed) when one exits non-zero or
        ``timeout_s`` passes first."""
        deadline = time.monotonic() + timeout_s
        while True:
            rcs = [p.poll() for p in self.procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                self.kill()
                raise RankFailure(f"rank {bad[0]} exited {rcs[bad[0]]}:\n"
                                  f"{self._tails()}")
            if all(rc == 0 for rc in rcs):
                return [self._read(r, 0) for r in range(len(self.procs))]
            if time.monotonic() > deadline:
                self.kill()
                raise RankFailure(f"ranks not done after {timeout_s} s "
                                  f"(killed):\n{self._tails()}")
            time.sleep(0.05)

    def kill(self) -> None:
        """Kill every child that still runs and reap it."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self) -> None:
        self.kill()
        for out, err in self._files:
            out.close()
            err.close()
        self._dir.cleanup()

    def __enter__(self) -> "LocalRanks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
