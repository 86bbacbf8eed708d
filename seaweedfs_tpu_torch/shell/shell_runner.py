"""Interactive admin REPL (weed/shell/shell_liner.go) and the master's
maintenance cron runner (weed/server/master_server.go:183
startAdminScripts: when leader, run the configured admin script lines
on a fixed period). The port of seaweedfs_tpu/shell/shell_runner.py;
stop() joins the runner's thread."""

from __future__ import annotations

import sys
import threading

from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.commands import COMMANDS, run_command


def _arm_readline():
    """Line editing + history + tab completion on a real terminal —
    the operator experience the reference gets from peterh/liner
    (shell_liner.go: history file, prompt editing, command completion).
    No-op when stdin is piped/scripted or readline is unavailable."""
    import atexit
    import os

    try:
        import readline
    except ImportError:  # pragma: no cover - always present on linux
        return None

    def complete(text, state):
        names = sorted(n for n in COMMANDS if n.startswith(text))
        return names[state] if state < len(names) else None

    readline.set_completer(complete)
    readline.set_completer_delims(" \t")
    readline.parse_and_bind("tab: complete")
    hist = os.path.expanduser("~/.seaweedfs_tpu_torch_shell_history")
    try:
        readline.read_history_file(hist)
    except OSError:
        pass
    readline.set_history_length(1000)
    atexit.register(lambda: _save_history(readline, hist))
    return readline


def _save_history(readline, hist: str) -> None:
    try:
        readline.write_history_file(hist)
    except OSError:
        pass


def run_shell(masters: list[str], stdin=None, stdout=None) -> None:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    env = CommandEnv(masters)
    # readline only drives the REAL tty path: input() reads through it
    # when stdin/stdout are the process's own terminal
    interactive = (
        stdin is sys.stdin
        and stdout is sys.stdout
        and hasattr(stdin, "isatty")
        and stdin.isatty()
    )
    if interactive:
        _arm_readline()
    print("seaweedfs-tpu-torch shell; `help` lists commands, `exit` quits", file=stdout)
    while True:
        if interactive:
            try:
                line = input("> ")
            except EOFError:
                return
            except KeyboardInterrupt:
                print(file=stdout)
                continue
        else:
            print("> ", end="", file=stdout, flush=True)
            line = stdin.readline()
            if not line:
                return
        if line.strip() in ("exit", "quit"):
            return
        line = line.strip()
        if not line:
            continue
        try:
            out = run_command(env, line)
            if out:
                print(out, end="", file=stdout)
        except Exception as e:  # noqa: BLE001 — REPL keeps running
            print(f"error: {e}", file=stdout)


DEFAULT_MAINTENANCE_SCRIPTS = [
    # what the reference master cron runs every 17 min when leader
    # (master_server.go:183-249)
    "ec.encode -fullPercent=95",
    "ec.rebuild -force",
    "ec.balance -force",
    "volume.balance -force",
    "volume.fix.replication",
]


class MaintenanceRunner:
    """Background admin-script loop (startAdminScripts). Attach to a
    master with `start()`; each period it runs the script lines through
    the same command table the shell uses."""

    def __init__(
        self,
        masters: list[str],
        scripts: list[str] | None = None,
        period_s: float = 17 * 60,
        is_leader=lambda: True,
    ):
        self.env = CommandEnv(masters)
        self.scripts = DEFAULT_MAINTENANCE_SCRIPTS if scripts is None else scripts
        self.period_s = period_s
        self.is_leader = is_leader
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_output: list[str] = []

    def run_once(self) -> list[str]:
        outputs = []
        for line in self.scripts:
            parts = line.split()
            if not parts:
                continue
            if parts[0] not in COMMANDS:
                outputs.append(f"{line}: unknown command")
                continue
            try:
                outputs.append(run_command(self.env, line))
            except Exception as e:  # noqa: BLE001 — cron keeps going
                outputs.append(f"{line}: {e}")
        self.last_output = outputs
        return outputs

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                if self.is_leader():
                    self.run_once()
            except Exception as e:  # noqa: BLE001 — the cron thread must survive
                self.last_output = [f"maintenance pass failed: {e}"]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
