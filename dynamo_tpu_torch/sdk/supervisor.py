"""Process supervision: ManagedProcess (spawn/monitor/restart one child)
and Supervisor (a fleet of them).

The port's own copy of dynamo_tpu/sdk/supervisor.py; its children resolve
``dynamo_tpu_torch`` through ``PYTHONPATH``.

Role-equivalent of the reference's serving/circus arbiter
(deploy/sdk/src/dynamo/sdk/cli/serving.py:152 `_create_watcher`) and of its
test harness's ManagedProcess (tests/utils/managed_process.py:69) — one
implementation serves both production serve-graphs and the kill-based
fault-tolerance suite (tests/fault_tolerance/test_runner.py:100-152).

Crash-restart discipline: a child that exits while not stopped restarts
after an exponential backoff, up to `max_restarts` within `restart_window_s`
(the budget refills as crashes age out). Discovery-side cleanup is the
fabric lease's job — a killed worker's instances vanish when its lease
expires; the supervisor's job is only to put a fresh process back.

ISSUE 11 — self-healing supervision:

  * **quarantine, not give-up**: a child that exhausts its crash budget
    enters QUARANTINE — slow-cadence retries with capped exponential
    backoff — instead of being abandoned forever (which silently shrank
    the fleet). Entering quarantine fires ``on_giveup`` so the planner
    can substitute capacity NOW; a retry that stays healthy for a
    probation window exits quarantine (``on_recover``), crash budget
    refilled.
  * **health probes**: an optional async ``health_probe`` is polled
    while the child runs; ``health_fails`` consecutive failures treat
    the child as wedged — it is killed (counted as a crash) and the
    normal restart discipline applies. A process that is alive but not
    serving is just a slower crash.
  * **injected kills are free**: the FT-test ``kill()`` hook restarts
    the child WITHOUT burning the crash budget — chaos suites must not
    be able to push a healthy child into quarantine.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import signal
import sys
import time
from typing import Awaitable, Callable, Optional

logger = logging.getLogger("dynamo_tpu_torch.sdk.supervisor")


class ManagedProcess:
    def __init__(
        self,
        args: list[str],
        *,
        name: str,
        env: Optional[dict[str, str]] = None,
        restart: bool = True,
        max_restarts: int = 5,
        restart_window_s: float = 60.0,
        backoff_s: float = 0.5,
        on_exit: Optional[Callable[[int], None]] = None,
        forward_output: bool = True,
        health_probe: Optional[Callable[[], Awaitable[bool]]] = None,
        health_interval_s: float = 5.0,
        health_fails: int = 3,
        quarantine_retry_s: float = 30.0,
        quarantine_retry_max_s: float = 300.0,
        quarantine_probation_s: Optional[float] = None,
        on_giveup: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.args = args
        self.name = name
        self.env = {**os.environ, **(env or {})}
        self.restart = restart
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.backoff_s = backoff_s
        self.on_exit = on_exit
        self.forward_output = forward_output
        self.health_probe = health_probe
        self.health_interval_s = health_interval_s
        self.health_fails = health_fails
        self.quarantine_retry_s = quarantine_retry_s
        self.quarantine_retry_max_s = quarantine_retry_max_s
        # a quarantined child must stay up this long to be trusted again
        self.quarantine_probation_s = (
            quarantine_probation_s
            if quarantine_probation_s is not None
            else restart_window_s
        )
        self.on_giveup = on_giveup
        self.on_recover = on_recover
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.restarts = 0
        self.quarantines = 0  # times the crash budget was exhausted
        self.quarantined = False
        self.health_kills = 0  # children killed by failed health probes
        self._injected_kills = 0  # pending budget-exempt kills (kill())
        # pending planned terminations (mark_planned_exit()): the next
        # exit — however delivered (external SIGTERM from an upgrade
        # coordinator, drain-deadline SIGKILL) — is a retirement, not a
        # crash: budget exempt, no restart, no quarantine
        self._planned_exits = 0
        self.planned_exits_total = 0
        self._crash_times: list[float] = []
        self._stopping = False
        self._monitor_task: Optional[asyncio.Task] = None
        self._health_task: Optional[asyncio.Task] = None
        self._started = asyncio.Event()

    # ------------------------------------------------------------ control

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc else None

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.returncode is None

    @property
    def state(self) -> str:
        if self._stopping:
            return "stopped"
        if self.quarantined:
            return "quarantined"
        return "running" if self.running else "backoff"

    async def start(self) -> None:
        await self._spawn()
        loop = asyncio.get_running_loop()
        self._monitor_task = loop.create_task(self._monitor())
        if self.health_probe is not None:
            self._health_task = loop.create_task(self._health_loop())

    async def _spawn(self) -> None:
        out = None if self.forward_output else asyncio.subprocess.DEVNULL
        self.proc = await asyncio.create_subprocess_exec(
            *self.args, env=self.env, stdout=out, stderr=out
        )
        self._started.set()
        logger.info("[%s] started pid %d", self.name, self.proc.pid)

    async def _monitor(self) -> None:
        while True:
            assert self.proc is not None
            spawned_at = time.monotonic()
            rc = await self.proc.wait()
            if self.on_exit is not None:
                try:
                    self.on_exit(rc)
                except Exception:  # noqa: BLE001 — callback is advisory
                    logger.exception("[%s] on_exit callback failed", self.name)
            if self._stopping:
                return
            if self._planned_exits > 0:
                # planned termination (scale-down / rolling upgrade): a
                # clean retirement — even when the drain deadline ended in
                # SIGKILL — must not feed the crash-loop quarantine budget
                # or fight the coordinator with an unwanted respawn
                self._planned_exits -= 1
                self.planned_exits_total += 1
                self._stopping = True  # retired: state=stopped, probes off
                if self._health_task is not None:
                    self._health_task.cancel()
                logger.info(
                    "[%s] planned termination rc=%d — budget exempt, "
                    "not restarting", self.name, rc,
                )
                return
            if not self.restart:
                logger.info("[%s] exited rc=%d (no restart)", self.name, rc)
                return
            now = time.monotonic()
            if self._injected_kills > 0:
                # fault-injection kill(): restart promptly, crash budget
                # untouched — chaos suites must not quarantine healthy
                # children
                self._injected_kills -= 1
                logger.info(
                    "[%s] injected kill — restarting (budget exempt)",
                    self.name,
                )
                await asyncio.sleep(self.backoff_s)
                if self._stopping:
                    return
                self.restarts += 1
                await self._spawn()
                continue
            if self.quarantined and now - spawned_at >= (
                self.quarantine_probation_s
            ):
                # the child survived probation before this (new) crash:
                # it had earned its way out — treat this as a fresh crash
                self._exit_quarantine()
            self._crash_times = [
                t for t in self._crash_times
                if now - t < self.restart_window_s
            ]
            self._crash_times.append(now)
            if (
                not self.quarantined
                and len(self._crash_times) > self.max_restarts
            ):
                # crash loop: budget exhausted. NOT the old permanent
                # give-up — quarantine keeps slow-cadence retries going
                # while on_giveup lets the planner substitute capacity.
                self.quarantined = True
                self.quarantines += 1
                logger.error(
                    "[%s] crashed %d times in %.0fs — QUARANTINED "
                    "(slow retries every %.0f-%.0fs; planner notified)",
                    self.name, len(self._crash_times),
                    self.restart_window_s, self.quarantine_retry_s,
                    self.quarantine_retry_max_s,
                )
                if self.on_giveup is not None:
                    try:
                        self.on_giveup(self.name)
                    except Exception:  # noqa: BLE001 — advisory
                        logger.exception(
                            "[%s] on_giveup callback failed", self.name
                        )
            if self.quarantined:
                # capped exponential slow cadence, counted from the
                # retries SINCE quarantine entry
                n = max(0, len(self._crash_times) - self.max_restarts - 1)
                delay = min(
                    self.quarantine_retry_s * (2 ** n),
                    self.quarantine_retry_max_s,
                )
            else:
                delay = self.backoff_s * (2 ** (len(self._crash_times) - 1))
            logger.warning(
                "[%s] exited rc=%d — restarting in %.1fs (%d/%d%s)",
                self.name, rc, delay, len(self._crash_times),
                self.max_restarts,
                ", quarantined" if self.quarantined else "",
            )
            await asyncio.sleep(delay)
            if self._stopping:
                return
            self.restarts += 1
            await self._spawn()
            if self.quarantined:
                # probation: if the child is still up after the window,
                # trust it again (the monitor may be stuck in wait() —
                # run the check on the side)
                asyncio.get_running_loop().create_task(
                    self._probation_check()
                )

    async def _probation_check(self) -> None:
        proc = self.proc
        with contextlib.suppress(asyncio.CancelledError):
            await asyncio.sleep(self.quarantine_probation_s)
            if (
                self.quarantined
                and not self._stopping
                and self.proc is proc
                and self.running
            ):
                self._exit_quarantine()

    def _exit_quarantine(self) -> None:
        self.quarantined = False
        self._crash_times.clear()
        logger.info(
            "[%s] healthy through probation — quarantine lifted", self.name
        )
        if self.on_recover is not None:
            try:
                self.on_recover(self.name)
            except Exception:  # noqa: BLE001 — advisory
                logger.exception("[%s] on_recover callback failed", self.name)

    async def _health_loop(self) -> None:
        """Poll health_probe; `health_fails` consecutive failures kill the
        child (a real crash — the budget applies: a child that is alive
        but wedged forever must eventually quarantine too)."""
        fails = 0
        with contextlib.suppress(asyncio.CancelledError):
            while not self._stopping:
                await asyncio.sleep(self.health_interval_s)
                if not self.running:
                    fails = 0  # monitor owns dead children
                    continue
                try:
                    healthy = bool(await self.health_probe())
                except Exception:  # noqa: BLE001 — probe error = unhealthy
                    healthy = False
                fails = 0 if healthy else fails + 1
                if fails >= self.health_fails:
                    fails = 0
                    self.health_kills += 1
                    logger.error(
                        "[%s] failed %d health probes — killing wedged "
                        "child pid %s", self.name, self.health_fails,
                        self.pid,
                    )
                    if self.proc is not None and self.proc.returncode is None:
                        with contextlib.suppress(ProcessLookupError):
                            self.proc.kill()

    async def stop(self, timeout: float = 5.0) -> None:
        """Graceful stop: SIGTERM, wait, SIGKILL. The SIGTERM leg is the
        KV-preserving drain path — the child's runner finishes in-flight
        work and (when configured) checkpoints its warm KV tiers before
        exiting, so planner scale-downs never SIGKILL hot KV."""
        self._stopping = True
        if self._health_task is not None:
            self._health_task.cancel()
        if self.proc is not None and self.proc.returncode is None:
            try:
                self.proc.terminate()
            except ProcessLookupError:
                pass
            try:
                await asyncio.wait_for(self.proc.wait(), timeout)
            except asyncio.TimeoutError:
                logger.warning("[%s] SIGKILL after %.0fs", self.name, timeout)
                try:
                    self.proc.kill()
                except ProcessLookupError:
                    pass
                await self.proc.wait()
        if self._monitor_task is not None:
            with_suppress = self._monitor_task
            with_suppress.cancel()
            try:
                await with_suppress
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    def mark_planned_exit(self) -> None:
        """Declare the NEXT exit of this child a planned termination
        (rolling-upgrade drain, planner scale-down delivered by external
        signal rather than stop()): the monitor treats it as a clean
        retirement — crash budget untouched, no restart, no quarantine —
        exactly as injected kills are budget-exempt. Idempotent per exit:
        each call covers one exit."""
        self._planned_exits += 1

    def kill(self) -> None:
        """SIGKILL without marking stopped — the monitor restarts it.
        This is the fault-injection hook the FT tests use; injected
        kills are exempt from the crash-restart budget so a chaos suite
        cannot push a healthy child into quarantine."""
        if self.proc is not None and self.proc.returncode is None:
            self._injected_kills += 1
            try:
                os.kill(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                self._injected_kills -= 1

    async def wait_restarted(
        self, prev_restarts: int, timeout: float = 30.0
    ) -> None:
        """Block until a restart beyond `prev_restarts` has spawned."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.restarts > prev_restarts and self.running:
                return
            await asyncio.sleep(0.05)
        raise TimeoutError(f"{self.name} did not restart within {timeout}s")


class Supervisor:
    """A named fleet of ManagedProcesses started/stopped together."""

    def __init__(self) -> None:
        self.procs: dict[str, ManagedProcess] = {}

    def add(self, proc: ManagedProcess) -> ManagedProcess:
        if proc.name in self.procs:
            raise ValueError(f"duplicate process name {proc.name!r}")
        self.procs[proc.name] = proc
        return proc

    def add_python(
        self, name: str, module: str, *argv: str,
        env: Optional[dict[str, str]] = None, **kw,
    ) -> ManagedProcess:
        # children must resolve dynamo_tpu_torch no matter the parent's cwd
        import dynamo_tpu_torch

        repo_root = os.path.dirname(os.path.dirname(dynamo_tpu_torch.__file__))
        child_env = dict(env or {})
        existing = child_env.get("PYTHONPATH") or os.environ.get("PYTHONPATH")
        child_env["PYTHONPATH"] = (
            repo_root + (os.pathsep + existing if existing else "")
        )
        return self.add(
            ManagedProcess(
                [sys.executable, "-m", module, *argv],
                name=name, env=child_env, **kw,
            )
        )

    async def start_all(self) -> None:
        for p in self.procs.values():
            if p.proc is None:
                await p.start()

    async def stop_all(self, timeout: Optional[float] = None) -> None:
        """Stop services first (concurrently), control-plane processes
        (`stop_last=True`, e.g. the fabric server) afterwards — otherwise
        workers block their graceful deregistration on a dead fabric and
        eat the SIGKILL timeout.

        The default SIGKILL deadline leaves headroom for each child's
        graceful drain (runner.py: stop admission -> finish in-flight,
        bounded by DYN_DRAIN_TIMEOUT_S -> deregister -> exit)."""
        if timeout is None:
            timeout = float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "10")) + 2.0
        first = [
            p for p in self.procs.values()
            if not getattr(p, "stop_last", False)
        ]
        last = [p for p in self.procs.values() if getattr(p, "stop_last", False)]
        await asyncio.gather(
            *(p.stop(timeout) for p in first), return_exceptions=True
        )
        await asyncio.gather(
            *(p.stop(timeout) for p in last), return_exceptions=True
        )

    def stats(self) -> dict:
        """Fleet supervision counters for the metrics plane
        (`dyn_supervisor_restarts_total` / `dyn_supervisor_quarantined`)."""
        return {
            "restarts_total": sum(p.restarts for p in self.procs.values()),
            "quarantined": sum(
                1 for p in self.procs.values() if p.quarantined
            ),
            "quarantines_total": sum(
                p.quarantines for p in self.procs.values()
            ),
            "health_kills_total": sum(
                p.health_kills for p in self.procs.values()
            ),
            "planned_exits_total": sum(
                p.planned_exits_total for p in self.procs.values()
            ),
        }

    def __getitem__(self, name: str) -> ManagedProcess:
        return self.procs[name]
