"""Wire protocol: length-prefixed JSON frames (docs/SERVING.md).

The port's copy of the JAX package's serve/protocol.py.  The frames are
byte-for-byte the JAX package's (same JSON separators, prefix, flag bit
and crc32), so a client of either package talks to a daemon of the other.

One frame = a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON encoding a single object.  Both directions use the
same framing; a connection carries any number of request/response pairs
in order (no pipelining guarantees beyond FIFO per connection).

Requests are objects with an ``op`` field (``ping`` / ``health`` /
``load`` / ``reload`` / ``query`` / ``mutate`` / ``versions`` /
``stats`` / ``trace`` / ``metrics`` / ``posture`` / ``shutdown``);
responses carry ``ok: true`` plus op-specific fields, or ``ok: false``
with a typed ``error`` object mirroring the supervisor taxonomy
(``{"type", "message", "exit_code"}`` — docs/RESILIENCE.md exit-code
table).  ``ping`` answers with the daemon's ``pid`` (the stale-socket
probe and "already running" diagnostics key on it); ``health`` is the
readiness report (docs/SERVING.md probe table).  ``query`` accepts an
optional ``deadline_s`` number — a client-relative budget the server
uses to shed requests whose caller has already given up.  Query ids
and F values are plain JSON numbers: F fits in int64 and JSON numbers
are exact through 2^53, far beyond any sum of n hop-distances this
system can hold in HBM.

Observability fields (docs/OBSERVABILITY.md): any request MAY carry an
optional ``trace`` object (``{"trace_id": <hex string>}``) naming the
distributed-trace context the handling should be attributed to; the
rollout is tolerated-absent exactly like the crc flag — receivers
ignore unknown fields, so a pre-trace peer interoperates unchanged in
both directions.  ``trace`` (the op) returns a trace's recorded span
events; ``metrics`` returns a Prometheus text exposition snapshot.

The length prefix is bounded (:data:`MAX_FRAME_BYTES`,
``MSBFS_SERVE_MAX_FRAME`` overrides): a corrupt or hostile prefix must
never turn into a multi-GiB allocation — the same fail-before-allocate
posture as the binary graph loader (utils/io.py header checks).

Frame integrity: the high bit of the length prefix (:data:`_CRC_FLAG`)
flags that a 4-byte big-endian crc32 of the body follows the prefix.
Frames WITHOUT the flag are always accepted (tolerated-absent), so the
compat is one-way: a pre-crc peer can SEND to this version, but it
cannot parse a flagged frame (its prefix read sees a length >= 2^31
and errors).  Rolling a mixed-version fleet forward therefore takes
two phases, the standard recipe: first deploy every node with
``MSBFS_WIRE_CRC=legacy`` — send unflagged frames, still verify any
flagged frame received — then, once no pre-crc peer remains, unset the
knob (default ``on``) to turn checksummed sends on everywhere.  A crc
mismatch raises :class:`FrameCorruptError`, which both seams convert to
the TRANSIENT class, not Input: the payload was damaged in flight, a
resend or a different replica plausibly succeeds, and the fleet
router's failover path (serve/router.py) handles it like any dropped
connection.  The checksum lives OUTSIDE the JSON on purpose — a flipped
bit can destroy the body's parseability, so an in-band checksum field
could never be read back off a corrupt frame.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from typing import Optional

from ..utils import faults, knobs

_LEN = struct.Struct("!I")
_CRC = struct.Struct("!I")

# The flag bit caps checksummed frames at 2 GiB - 1; the 64 MiB frame
# bound (and any sane override) sits far below it.
_CRC_FLAG = 0x80000000

# 64 MiB default: a 255-group x 255-source query batch plus its response
# is < 1 MiB of JSON, so this bounds damage, not capability.
MAX_FRAME_BYTES = 64 << 20


class ProtocolError(ValueError):
    """Malformed frame (oversized prefix, truncated body, non-JSON,
    non-object payload).  Classified as InputError at the server seam."""


class FrameCorruptError(ProtocolError):
    """A frame whose body does not match its crc32: damaged in flight,
    not malformed by the sender.  Classified as TransientError at both
    seams (resend/failover recovers), unlike its ProtocolError parent.
    """


def max_frame_bytes() -> int:
    """The active bound (env-overridable, malformed values fall back —
    the repo-wide knob convention)."""
    raw = knobs.raw("MSBFS_SERVE_MAX_FRAME", "")
    if raw:
        try:
            v = int(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    return MAX_FRAME_BYTES


def crc_sends_enabled() -> bool:
    """``MSBFS_WIRE_CRC``: ``on`` (default) sends checksummed flagged
    frames; ``legacy`` (or ``off``/``0``) sends unflagged pre-crc
    frames that any older peer can parse — the phase-1 setting of the
    two-phase rolling upgrade (module docstring).  Receiving is NOT
    gated: flagged frames are verified, unflagged frames accepted,
    whatever the knob says."""
    raw = knobs.raw("MSBFS_WIRE_CRC", "on").strip().lower()
    return raw not in ("legacy", "off", "0")


def encode_frame(obj: dict, crc: Optional[bool] = None) -> bytes:
    """One object -> one frame.  ``crc`` None defers to the
    ``MSBFS_WIRE_CRC`` knob; True/False force the framing (tests)."""
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > max_frame_bytes() or len(body) >= _CRC_FLAG:
        raise ProtocolError(
            f"frame of {len(body)} bytes exceeds the "
            f"{min(max_frame_bytes(), _CRC_FLAG - 1)}-byte bound"
        )
    if crc is None:
        crc = crc_sends_enabled()
    if not crc:
        return _LEN.pack(len(body)) + body
    return (
        _LEN.pack(len(body) | _CRC_FLAG)
        + _CRC.pack(zlib.crc32(body))
        + body
    )


# ``net_reorder`` holds one outbound frame per thread so the NEXT frame
# overtakes it on the wire; _flush_held delivers stragglers before any
# read on the same thread (a held request with no successor would
# otherwise deadlock the request/response pair waiting on itself).
_REORDER = threading.local()


def _flush_held() -> None:
    held = getattr(_REORDER, "held", None)
    if not held:
        return
    _REORDER.held = []
    for held_sock, held_frame in held:
        try:
            held_sock.sendall(held_frame)
        except OSError:
            # The overtaking frame's connection may already be gone —
            # delivering late to a dead peer is exactly what a reordered
            # network does; the receiver side's framing survives either
            # way.
            pass


def send_frame(sock: socket.socket, obj: dict) -> None:
    frame = encode_frame(obj)
    if faults.consume_wire_taint():
        # ``wire_corrupt`` chaos seam: flip one body bit AFTER the crc32
        # was computed — the receiver's checksum check is the recovery
        # path under test (a taint on an empty body degrades to nothing
        # to flip, which no real frame has).  Legacy-mode frames have no
        # crc word, so locate the body off the flag bit, not a fixed 8.
        (prefix_word,) = _LEN.unpack(frame[: _LEN.size])
        prefix = _LEN.size + (
            _CRC.size if prefix_word & _CRC_FLAG else 0
        )
        if len(frame) > prefix:
            buf = bytearray(frame)
            buf[prefix + (len(buf) - prefix) // 2] ^= 0x10
            frame = bytes(buf)
    # Network chaos seam (utils/faults.py "Network chaos kinds"): whole-
    # frame filters armed by the router's trip, consumed here so the
    # fault fires at the protocol boundary itself — the receiver (and
    # the dedup window, and the failover walk) sees byte-for-byte what a
    # lossy network would deliver.
    dup = False
    for filt in faults.consume_frame_chaos():
        mode = filt["mode"]
        if mode == "drop":
            _flush_held()
            faults.raise_partition_drop(
                filt["replica"], filt["side"], filt["target_side"]
            )
        if mode == "delay":
            time.sleep(filt["delay_ms"] / 1000.0)
        elif mode == "dup":
            dup = True
        elif mode == "reorder":
            held = getattr(_REORDER, "held", None)
            if held is None:
                held = _REORDER.held = []
            held.append((sock, frame))
            return
        elif mode == "half_open":
            # The peer's SYN/ACK state survived but its process is gone:
            # our write vanishes (reported as success — TCP buffers it),
            # and the response never arrives.  Arm the read black hole
            # and write NOTHING.
            faults.arm_read_blackhole(filt["replica"])
            return
    sock.sendall(frame)
    if dup:
        # Retransmit-after-lost-ack: the same frame lands twice and the
        # receiver processes both copies.
        sock.sendall(frame)
    _flush_held()


def _read_exact(sock: socket.socket, count: int) -> Optional[bytes]:
    """Read exactly ``count`` bytes, or None on clean EOF at a frame
    boundary (mid-frame EOF is a ProtocolError: the peer vanished)."""
    chunks = []
    got = 0
    while got < count:
        chunk = sock.recv(min(count - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{count} bytes)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """One frame -> dict, or None on clean EOF (peer done)."""
    # A frame held for reordering must go out before this thread blocks
    # on a response, or the request/response pair deadlocks on itself.
    _flush_held()
    blackhole = faults.consume_read_blackhole()
    if blackhole is not None:
        faults.raise_half_open(blackhole)
    header = _read_exact(sock, _LEN.size)
    if header is None:
        return None
    (prefix,) = _LEN.unpack(header)
    want_crc = bool(prefix & _CRC_FLAG)
    length = prefix & ~_CRC_FLAG
    if length > max_frame_bytes():
        raise ProtocolError(
            f"frame prefix claims {length} bytes, bound is "
            f"{max_frame_bytes()}"
        )
    crc_expected = None
    if want_crc:
        crc_header = _read_exact(sock, _CRC.size)
        if crc_header is None:
            raise ProtocolError("connection closed between prefix and crc")
        (crc_expected,) = _CRC.unpack(crc_header)
    body = _read_exact(sock, length) if length else b""
    if body is None:
        raise ProtocolError("connection closed between prefix and body")
    if crc_expected is not None and zlib.crc32(body) != crc_expected:
        raise FrameCorruptError(
            f"frame crc32 mismatch: expected {crc_expected:#010x}, body "
            f"hashes to {zlib.crc32(body):#010x} ({length} bytes) — "
            "frame damaged in flight"
        )
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ProtocolError(f"frame body is not JSON: {exc}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"frame body must be a JSON object, got {type(obj).__name__}"
        )
    return obj


def error_body(err) -> dict:
    """Typed error -> the wire's ``error`` object (taxonomy class name,
    message, documented exit code — docs/RESILIENCE.md)."""
    return {
        "ok": False,
        "error": {
            "type": type(err).__name__,
            "message": str(err),
            "exit_code": int(getattr(err, "exit_code", 6)),
        },
    }


def parse_address(addr: str):
    """``unix:<path>`` or ``<host>:<port>`` -> (family, target).

    The unix form is the default deployment (single host, no TCP
    exposure); TCP is opt-in for multi-host clients.
    """
    if addr.startswith("unix:"):
        path = addr[len("unix:"):]
        if not path:
            raise ValueError("unix: address needs a socket path")
        return socket.AF_UNIX, path
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"address {addr!r}: want unix:<path> or <host>:<port>"
        )
    try:
        return socket.AF_INET, (host, int(port))
    except ValueError:
        raise ValueError(f"address {addr!r}: port {port!r} is not an "
                         "integer") from None


def _float_knob(name: str, fallback: float) -> float:
    raw = knobs.raw(name, str(fallback))
    try:
        v = float(raw)
    except ValueError:
        return fallback
    return v if v >= 0 else fallback


def net_connect_timeout_s() -> float:
    """``MSBFS_NET_CONNECT_TIMEOUT_S`` (default 5): bound on the TCP/unix
    connect handshake when the caller gave no explicit timeout — a
    partitioned or half-open peer must fail the dial in bounded time,
    not hang a router walk.  0 disables (blocking connect)."""
    return _float_knob("MSBFS_NET_CONNECT_TIMEOUT_S", 5.0)


def net_read_timeout_s() -> float:
    """``MSBFS_NET_READ_TIMEOUT_S`` (default 0 = inherit the caller's
    request timeout): per-read socket timeout after connect.  Non-zero
    turns a silent half-open peer into a timeout error the taxonomy
    classifies TRANSIENT, so the router fails over instead of waiting
    forever."""
    return _float_knob("MSBFS_NET_READ_TIMEOUT_S", 0.0)


def net_keepalive_enabled() -> bool:
    """``MSBFS_NET_KEEPALIVE`` (default 1): SO_KEEPALIVE on TCP legs so
    the kernel probes idle cross-machine connections and surfaces dead
    peers as errors instead of eternal silence.  Unix sockets never need
    it (a dead peer is an immediate EOF on the same host)."""
    raw = knobs.raw("MSBFS_NET_KEEPALIVE", "1").strip().lower()
    return raw not in ("0", "off", "false", "")


def connect(addr: str, timeout: Optional[float] = None) -> socket.socket:
    """Dial ``addr`` with the cross-machine transport discipline
    (docs/SERVING.md "Cross-machine transport & fencing"): the connect
    phase is bounded by ``timeout`` (or ``MSBFS_NET_CONNECT_TIMEOUT_S``
    when None), TCP legs get keepalive, and after the handshake the
    socket's read timeout is ``MSBFS_NET_READ_TIMEOUT_S`` if set, else
    the caller's ``timeout`` (None = blocking, the pre-TCP behavior)."""
    family, target = parse_address(addr)
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        connect_t = timeout if timeout is not None else net_connect_timeout_s()
        if connect_t:
            sock.settimeout(connect_t)
        sock.connect(target)
        if family == socket.AF_INET and net_keepalive_enabled():
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        read_t = net_read_timeout_s()
        sock.settimeout(read_t if read_t else timeout)
    except (OSError, ValueError):
        sock.close()
        raise
    return sock
