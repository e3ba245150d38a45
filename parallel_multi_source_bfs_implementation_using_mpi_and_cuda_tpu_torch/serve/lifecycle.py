"""Daemon lifecycle plumbing: signals and socket reclaim (docs/SERVING.md).

Two concerns that belong to the *process*, not the server object:

* :func:`install_signal_handlers` — SIGTERM/SIGINT ask the server for a
  graceful drain (stop accepting, finish in-flight work within the
  drain deadline, exit 0).  A second signal while draining forces an
  immediate stop: the operator escalating ``kill`` → ``kill`` again is
  telling us the deadline no longer matters.

* :func:`reclaim_stale_socket` — ``msbfs serve`` pointed at a unix
  socket path that already exists must decide between "another daemon
  owns this" (refuse, loudly, with its pid) and "a crashed daemon left
  this behind" (unlink and take over).  The probe is a real ``ping``
  round trip, not a connect test: a half-dead process can hold a
  connectable socket without answering anything.
"""

from __future__ import annotations

import os
import signal
import socket
from typing import Optional

from ..runtime.supervisor import InputError
from ..utils.telemetry import dump_flight, log_line
from . import protocol


def install_signal_handlers(server) -> None:
    """SIGTERM/SIGINT -> ``server.request_drain()``; a repeat signal ->
    ``server.stop()`` (immediate).  Main-thread only (CPython signal
    rule); the handlers just flip events, the drain itself runs on the
    thread parked in ``server.wait()``.  Each signal also dumps the
    flight recorder (utils/telemetry.py): the ring's last-N events are
    exactly the post-mortem an operator wants from a killed daemon."""

    def _handler(signum, frame):  # noqa: ARG001 — signal handler shape
        name = signal.Signals(signum).name
        dump_flight(f"sig{name}")
        if server.draining or server.stopping:
            log_line(
                f"msbfs serve: second {name} — stopping immediately",
                event="signal_stop", signal=name,
            )
            server.stop()
            return
        log_line(
            f"msbfs serve: {name} received — draining "
            f"(deadline {server.drain_deadline_s:g}s)",
            event="signal_drain", signal=name,
        )
        server.request_drain()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def probe_socket(path: str, timeout: float = 1.0) -> Optional[int]:
    """Ping the unix socket at ``path``.  Returns the answering daemon's
    pid (or -1 if it answered without one) when a live server responds;
    None when nothing usable is listening (connection refused, timeout,
    framing garbage — all read as "dead")."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        sock.connect(path)
        protocol.send_frame(sock, {"op": "ping"})
        response = protocol.recv_frame(sock)
    except (OSError, protocol.ProtocolError):
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass
    if not isinstance(response, dict) or not response.get("ok"):
        return None
    return int(response.get("pid", -1))


def reclaim_stale_socket(listen: str) -> None:
    """Startup guard for unix addresses whose path already exists.

    Live daemon answering a ping -> :class:`InputError` naming its pid
    (exit code 1: the operator pointed two daemons at one socket).
    Anything else -> unlink the stale path so bind() can proceed.
    Non-unix addresses are a no-op (TCP rebinding is SO_REUSEADDR's
    problem, handled at bind time).
    """
    family, target = protocol.parse_address(listen)
    if family != socket.AF_UNIX or not isinstance(target, str):
        return
    if not os.path.exists(target):
        return
    pid = probe_socket(target)
    if pid is not None:
        who = f"pid {pid}" if pid > 0 else "unknown pid"
        raise InputError(
            f"a daemon is already running on {listen} ({who}); "
            "stop it first or choose another --listen path"
        )
    log_line(
        f"msbfs serve: removing stale socket {target} "
        "(no daemon answered)",
        event="stale_socket_reclaim", path=target,
    )
    try:
        os.unlink(target)
    except FileNotFoundError:
        pass
