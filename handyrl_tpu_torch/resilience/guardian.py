"""Learner relaunch supervision: auto-resume behind a circuit breaker.

A copy of ``handyrl_tpu.resilience.guardian``.  The
:class:`~.supervisor.Supervisor` keeps the actor fleet alive; this
module applies the same policy to the learner process itself.
:class:`LearnerGuard` runs the learner as a child process and, when it
dies (crash, OOM, SIGKILL preemption), relaunches it with
``restart_epoch: auto`` so the child resumes from the newest valid
manifest entry and replays its episode WAL.  Relaunches ride a
:class:`BackoffPolicy` schedule, and more than ``max_restarts``
failures inside ``failure_window`` seconds trip the circuit breaker: a
checkpoint that crashes every resume ends the run loudly instead of a
restart storm.

The spawn, clock and sleep are injectable.  Production spawns a
spawn-context ``multiprocessing.Process``: the child creates its own
CUDA context, and the guard's own process never touches the card.
"""

import time
from typing import Callable, Optional

from .supervisor import BackoffPolicy, FailureWindow


def _spawn_process(target, args):
    """Default spawn: the learner entry point in a spawn-context child
    (a CUDA context does not survive fork)."""
    from ..connection import _mp

    proc = _mp.Process(target=target, args=(args,))
    proc.start()
    return proc


class LearnerGuard:
    """Run ``target(args)`` in a supervised child until it exits clean.

    ``run()`` returns the final exit code: 0 after a clean finish, the
    last child's code once the circuit breaker trips.  Each relaunch
    rewrites ``train_args.restart_epoch`` to ``"auto"`` — the whole
    point of the guard is that recovery needs no config surgery."""

    def __init__(self, target: Callable, args: dict,
                 max_restarts: int = 5, failure_window: float = 600.0,
                 policy: Optional[BackoffPolicy] = None,
                 spawn: Callable = _spawn_process,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.target = target
        self.args = args
        self.policy = policy if policy is not None else BackoffPolicy()
        self.spawn = spawn
        self.clock = clock
        self.sleep = sleep
        self.restarts = 0
        self.tripped = False
        # the actor supervisor's breaker semantics, shared verbatim
        self._failures = FailureWindow(max_restarts, failure_window)

    @classmethod
    def from_args(cls, target: Callable, args: dict) -> "LearnerGuard":
        """Policy knobs from the train-args mapping: the learner reuses
        the fleet's ``max_respawns`` / ``respawn_backoff`` keys — one
        restart-storm policy for the whole system."""
        train = dict(args.get("train_args") or {})
        return cls(
            target, args,
            max_restarts=int(train.get("max_respawns", 5)),
            policy=BackoffPolicy(
                base=float(train.get("respawn_backoff", 0.5) or 0.5)),
        )

    def _resume_args(self) -> dict:
        """Relaunch args: same config, but resume from the manifest."""
        args = dict(self.args)
        args["train_args"] = dict(args.get("train_args") or {})
        args["train_args"]["restart_epoch"] = "auto"
        return args

    def run(self) -> int:
        args = self.args
        while True:
            child = self.spawn(self.target, args)
            child.join()
            code = child.exitcode
            if code == 0:
                if self.restarts:
                    print(f"learner guard: training finished after "
                          f"{self.restarts} relaunch(es)")
                return 0
            now = self.clock()
            if self._failures.record(now):
                self.tripped = True
                print(f"ERROR: learner guard: circuit breaker tripped "
                      f"after {len(self._failures)} failures in "
                      f"{self._failures.window:.0f}s — a checkpoint "
                      "that crashes every resume is a poison "
                      "checkpoint; not relaunching (exit code "
                      f"{code})")
                return int(code if code is not None else 1)
            delay = self.policy.delay(len(self._failures) - 1)
            print(f"learner guard: learner exited {code}; relaunching "
                  f"with restart_epoch: auto in {delay:.2f}s "
                  f"(failure {len(self._failures)})")
            self.sleep(delay)
            self.restarts += 1
            args = self._resume_args()
